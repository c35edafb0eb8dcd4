"""The port's own spans and transfer counters (``superscreen_tpu_torch.tracing``):
recorded only while a ``torch.profiler`` profile is open, one span tree per
entry call, the same results with and without the profiler, host operations
with no device-side event, counters that count only copies between the
host and a card, and a warm ``solve()`` that checks no polygon ring.  This
file imports neither JAX nor ``superscreen_tpu``; its one ``gpu`` test runs
on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import superscreen_tpu_torch as st
from superscreen_tpu_torch import tracing
from superscreen_tpu_torch.ops import cuda_kernels, linalg
from superscreen_tpu_torch.squids import scanning

torch.set_num_threads(2)

FIELDS = (0.1, 0.4, 0.7)
ITERATIONS = 1
#: Triangular solves of one refined film solve (``refine_steps`` = 2): the
#: solve and one per refinement step, each on packed LU factors.
REFINED = 1 + 2
#: The LU film solves of the two rings' calls: ``solve_many`` leaves its
#: first round unrefined (one solve per film) and refines its last;
#: ``solve`` refines every one of its ``ITERATIONS + 1`` rounds; the scan
#: refines its sample film's one solve.
SWEEP_SOLVES = 2 * (1 + REFINED)
SOLVE_SOLVES = 2 * (ITERATIONS + 1) * REFINED
SCAN_SOLVES = REFINED
PROGRAM_SPANS = {
    "solve_many", "solve", "factorize_model", "susceptibility_scan", "sweep.inputs",
    "sweep.film_solve", "sweep.coupling", "sweep.self_field", "sweep.results", "sweep.to_host",
    "factorize.assembly", "factorize.factor", "scan.maps", "scan.readout",
}


def _two_rings(dtype="float32"):
    layers = [st.Layer("layer0", Lambda=1, z0=0), st.Layer("layer1", Lambda=1, z0=1)]
    films = [
        st.Polygon("big_ring", layer="layer0", points=st.geometry.circle(7.5, points=80)),
        st.Polygon("little_ring", layer="layer1", points=st.geometry.circle(5, points=60)),
    ]
    holes = [
        st.Polygon("big_hole", layer="layer0", points=st.geometry.circle(3.75, points=40)),
        st.Polygon("little_hole", layer="layer1", points=st.geometry.circle(2.5, points=30)),
    ]
    device = st.Device("two_rings", layers=layers, films=films, holes=holes, solve_dtype=dtype)
    device.make_mesh(max_edge_length=1.5)
    return device


def _scan_devices():
    """A coarse mini susceptometer over a disk (config 5's shapes)."""
    squid = st.Device(
        "mini_squid",
        layers=[st.Layer("sq", Lambda=0.3, z0=0)],
        films=[st.Polygon("fc_ring", layer="sq", points=st.geometry.circle(1.5, points=40))],
        holes=[st.Polygon("fc_hole", layer="sq", points=st.geometry.circle(0.9, points=30))],
        abstract_regions=[st.Polygon("pl", layer="sq", points=st.geometry.circle(0.4, points=24))],
        length_units="um",
    )
    sample = st.Device(
        "sample",
        layers=[st.Layer("s", Lambda=0.1, z0=0)],
        films=[st.Polygon("disk", layer="s", points=st.geometry.circle(6.0, points=60))],
        length_units="um",
    )
    squid.make_mesh(min_points=200, smooth=3)
    sample.make_mesh(min_points=300, smooth=3)
    return squid, sample


@pytest.fixture(scope="module")
def setup():
    device = _two_rings()
    model = st.factorize_model(
        device=device, current_units="uA", circulating_currents={"big_hole": 2.0}, torch_device="cpu"
    )
    squid, sample = _scan_devices()
    squid_solution = st.solve(
        squid, circulating_currents={"fc_hole": "1 mA"}, field_units="mT", current_units="mA",
        progress_bar=False, torch_device="cpu",
    )[-1]
    sample_model = st.factorize_model(device=sample, current_units="uA", torch_device="cpu")
    return dict(device=device, model=model, squid_solution=squid_solution, sample_model=sample_model)


def _calls(setup, device="cpu"):
    """The four entry calls on the small models, each returning its arrays."""
    model = setup["model"]
    fields = [st.sources.ConstantField(b) for b in FIELDS]

    def solve_many():
        r = st.solve_many(model=model, applied_fields=fields, iterations=ITERATIONS, torch_device=device)
        return [r.streams, r.current_densities, r.self_fields, r.other_fields, r.applied_fields]

    def solve():
        sols = st.solve(
            model=model, applied_field=fields[1], iterations=ITERATIONS, progress_bar=False,
            torch_device=device,
        )
        return [
            {name: (fs.stream, fs.current_density, fs.self_field) for name, fs in s.film_solutions.items()}
            for s in sols
        ]

    def factorize_model():
        m = st.factorize_model(
            device=setup["device"], current_units="uA", circulating_currents={"big_hole": 2.0},
            torch_device=device,
        )
        return [{name: d.A for name, d in m.film_data.items()}]

    def susceptibility_scan():
        positions = np.column_stack([np.linspace(-4.0, 4.0, 3), np.zeros(3)])
        return [scanning.susceptibility_scan(
            sample_model=setup["sample_model"], squid_solution=setup["squid_solution"],
            positions=positions, squid_height=1.0, pickup_loop="pl", I_fc="1 mA", torch_device=device,
        )]

    return dict(
        solve_many=solve_many, solve=solve, factorize_model=factorize_model,
        susceptibility_scan=susceptibility_scan,
    )


@contextlib.contextmanager
def _profiled(activities=(ProfilerActivity.CPU,)):
    tracing.reset()
    with profile(activities=list(activities)) as prof:
        yield prof


def _tree(spans):
    """``(name, parent name)`` of each span, in the order they opened."""
    return [(s.name, None if s.parent is None else spans[s.parent].name) for s in spans]


def _sweep_tree(entry, films, rounds):
    solves = [("sweep.film_solve", entry)] * films
    for _ in range(rounds):
        solves += [("sweep.coupling", entry)] + [("sweep.film_solve", entry)] * films
    return (
        [(entry, None), ("sweep.inputs", entry)] + solves + [("sweep.self_field", entry)] * films
        + [("sweep.results", entry), ("sweep.to_host", "sweep.results")]
    )


EXPECTED = {
    "solve_many": _sweep_tree("solve_many", 2, ITERATIONS),
    "solve": _sweep_tree("solve", 2, ITERATIONS),
    "factorize_model": [
        ("factorize_model", None), ("factorize.assembly", "factorize_model"),
        ("factorize.factor", "factorize.assembly"), ("factorize.factor", "factorize.assembly"),
    ],
    "susceptibility_scan": [("susceptibility_scan", None), ("scan.maps", "susceptibility_scan")]
    + [(n, p or "susceptibility_scan") for n, p in _sweep_tree("solve_many", 1, 0)]
    + [("scan.readout", "susceptibility_scan")],
}


def test_nothing_is_recorded_without_a_profiler(setup):
    tracing.reset()
    for call in _calls(setup).values():
        call()
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


@pytest.mark.parametrize("entry", sorted(EXPECTED))
def test_each_entry_call_is_one_span_tree(setup, entry):
    call = _calls(setup)[entry]
    with _profiled():
        call()
        call()
    spans = tracing.snapshot()["spans"]
    half = len(spans) // 2
    assert len(spans) == 2 * len(EXPECTED[entry])
    for part in (spans[:half], spans[half:]):
        assert [s.call for s in part] == [part[0].call] * len(part)
        assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in part)
        for s in part[1:]:
            parent = spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert _tree(spans) == 2 * EXPECTED[entry]
    assert spans[0].call != spans[half].call


@pytest.mark.parametrize("entry", ["solve_many", "solve", "susceptibility_scan"])
def test_results_are_bitwise_the_same_under_the_profiler(setup, entry):
    call = _calls(setup)[entry]
    plain = call()
    with _profiled():
        traced = call()
    assert len(tracing.snapshot()["spans"]) > 0

    def flat(x):
        if isinstance(x, dict):
            return [a for k in sorted(x) for a in flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [a for v in x for a in flat(v)]
        return [np.asarray(x)]

    a, b = flat(plain), flat(traced)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_spans_are_host_operations_of_the_profiler(setup):
    with _profiled() as prof:
        for call in _calls(setup).values():
            call()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in PROGRAM_SPANS]
    assert {e.name() for e in events} == PROGRAM_SPANS
    for e in events:
        assert not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU
    recorded = tracing.snapshot()["spans"]
    assert sorted(e.name() for e in events) == sorted(s.name for s in recorded)


def test_counters_read_zero_on_the_cpu(setup):
    """No copy crosses to or from a card; the one counter that moves is the
    film solves' ``triangular_solves``, since every system on the CPU is
    LU-factorized."""
    with _profiled():
        for call in _calls(setup).values():
            call()
    snap = tracing.snapshot()
    assert snap["counters"] == {tracing.TRIANGULAR_SOLVES: SWEEP_SOLVES + SOLVE_SOLVES + SCAN_SOLVES}
    counted = [s for s in snap["spans"] if s.counts]
    assert {s.name for s in counted} == {"sweep.film_solve"}
    assert all(set(s.counts) == {tracing.TRIANGULAR_SOLVES} for s in counted)
    total = snap["counters"][tracing.TRIANGULAR_SOLVES]
    assert sum(s.counts[tracing.TRIANGULAR_SOLVES] for s in counted) == total


def test_solutions_own_device_copies_and_check_no_ring(setup):
    """A warm ``solve()`` gives each ``Solution`` a device of its own, equal
    to the model's, and checks no polygon ring: each copy carries the
    verdict of the ring it copies."""
    model = setup["model"]

    def call():
        return st.solve(
            model=model, applied_field=st.sources.ConstantField(FIELDS[1]), iterations=ITERATIONS,
            progress_bar=False, torch_device="cpu",
        )

    call()
    with _profiled():
        solutions = call()
    assert tracing.snapshot()["counters"].get(tracing.POLYGON_CHECKS, 0) == 0
    devices = [s.device for s in solutions]
    assert len(devices) == ITERATIONS + 1
    assert len({id(d) for d in devices + [model.device]}) == len(devices) + 1
    assert all(d == model.device for d in devices)


def test_counts_go_to_the_innermost_span_and_nested_entries_keep_the_call():
    with _profiled():
        with tracing.span("outer", entry=True):
            tracing.count(tracing.HOST_SYNCS)
            with tracing.span("inner", entry=True):
                tracing.count(tracing.D2H_BYTES, 64)
                tracing.count(tracing.HOST_SYNCS)
        with tracing.span("next", entry=True):
            pass
        with tracing.span("loose"):
            tracing.count(tracing.H2D_BYTES, 8)
    snap = tracing.snapshot()
    outer, inner, nxt, loose = snap["spans"]
    assert snap["counters"] == {"host_syncs": 2, "d2h_bytes": 64, "h2d_bytes": 8}
    assert outer.counts == {"host_syncs": 1}
    assert inner.counts == {"d2h_bytes": 64, "host_syncs": 1}
    assert (inner.parent, inner.call) == (0, outer.call)
    assert nxt.call not in (None, outer.call) and loose.call is None
    assert snap["launches"] is cuda_kernels.LAUNCHES and snap["cg"] is linalg.CG_STATS
    tracing.reset()
    assert tracing.snapshot()["spans"] == [] and tracing.snapshot()["counters"] == {}


def test_traced_functions_keep_their_names_and_signatures():
    import inspect

    from superscreen_tpu_torch import sweep

    for fn, name in [
        (st.solve_many, "solve_many"), (st.solve, "solve"), (st.factorize_model, "factorize_model"),
        (scanning.susceptibility_scan, "susceptibility_scan"), (sweep._solve_film_batch, "_solve_film_batch"),
        (linalg.factor_system, "factor_system"), (scanning._contour_flux, "_contour_flux"),
    ]:
        assert fn.__name__ == name
        assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)


def _weak_spot(x, y, x0=1.0, y0=0.5, sigma=1.0, depth=0.5):
    return 1.0 + depth * np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))


def _terminal_strip(dtype="float32"):
    """A coarse terminal strip with a hole and a weak spot in Lambda, drawn
    at its mesh's edge length as ``chip_smoke.transport_stack`` draws one."""
    width, height, h = 6.0, 3.0, 0.4
    film = st.Polygon(
        "strip", layer="base", points=st.geometry.box(width, height, points=int(2 * (width + height) / h))
    )
    hole = st.Polygon("strip_hole", layer="base", points=st.geometry.circle(0.6, points=10, center=(-1.5, 0.0)))
    terminals = [
        st.Polygon(name, points=st.geometry.box(h / 4, height, center=(x, 0)))
        for name, x in (("source", -width / 2), ("drain", width / 2))
    ]
    device = st.Device(
        "terminal_strip", layers=[st.Layer("base", Lambda=st.Parameter(_weak_spot), z0=0)], films=[film],
        holes=[hole], terminals={"strip": terminals}, solve_dtype=dtype,
    )
    device.make_mesh(min_points=250)
    return device


@pytest.fixture(scope="module")
def transport():
    device = _terminal_strip()
    vortices = [st.Vortex(x=1.2, y=0.4, film="strip"), st.Vortex(x=-0.5, y=-0.8, film="strip")]
    model = st.factorize_model(device=device, current_units="uA", vortices=vortices, torch_device="cpu")
    return dict(device=device, model=model)


def _bias_sweep(model, driven=True):
    """A three-point sweep of the terminal strip: bias and vortex
    amplitudes per point when ``driven``, the fields alone otherwise."""
    fields = [st.sources.ConstantField(b) for b in FIELDS]
    drive = {}
    if driven:
        drive = dict(
            terminal_currents=[{"strip": {"source": I, "drain": -I}} for I in (1.0, 2.5, 4.0)],
            vortex_nPhi0=np.array([[1.0, 0.0], [-1.0, 2.0], [0.0, -2.0]]),
        )
    r = st.solve_many(model=model, applied_fields=fields, torch_device="cpu", **drive)
    return [r.streams, r.current_densities, r.self_fields, r.applied_fields]


#: The bootstrap's solves per call: one unit solution per terminal (the
#: last terminal's is the centring direction), two solves each in a film
#: with a hole.
TERMINAL_SOLVES = 2 * 2
#: The strip's triangular solves per driven call on LU factors: each
#: bootstrap solve refined, and the sweep's one refined film solve.
STRIP_TRIANGULAR = TERMINAL_SOLVES * REFINED + REFINED


def test_terminal_and_vortex_spans_open_once_per_driven_sweep(transport):
    with _profiled():
        _bias_sweep(transport["model"])
    spans = tracing.snapshot()["spans"]
    tree = _tree(spans)
    assert tree[:4] == [
        ("solve_many", None), ("sweep.inputs", "solve_many"), ("sweep.vortices", "solve_many"),
        ("sweep.terminals", "solve_many"),
    ]
    assert [name for name, _ in tree].count("sweep.terminals") == 1
    assert [name for name, _ in tree].count("sweep.vortices") == 1
    terminals = next(s for s in spans if s.name == "sweep.terminals")
    assert terminals.counts == {
        tracing.TERMINAL_SOLVES: TERMINAL_SOLVES, tracing.TRIANGULAR_SOLVES: TERMINAL_SOLVES * REFINED
    }
    assert tracing.snapshot()["counters"] == {
        tracing.TERMINAL_SOLVES: TERMINAL_SOLVES, tracing.TRIANGULAR_SOLVES: STRIP_TRIANGULAR
    }


def test_terminal_and_vortex_spans_are_absent_without_their_drives(transport):
    with _profiled():
        _bias_sweep(transport["model"], driven=False)
    snap = tracing.snapshot()
    names = {s.name for s in snap["spans"]}
    assert "solve_many" in names and not names & {"sweep.terminals", "sweep.vortices"}
    assert snap["counters"] == {tracing.TRIANGULAR_SOLVES: REFINED}


@pytest.mark.parametrize("driven", [True, False], ids=["driven", "fields"])
def test_transport_results_are_bitwise_the_same_under_the_profiler(transport, driven):
    plain = _bias_sweep(transport["model"], driven)
    with _profiled():
        traced = _bias_sweep(transport["model"], driven)
    for a, b in zip(plain, traced):
        for name in a:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name])


def test_the_bootstrap_copies_go_through_the_transfer_counters(transport, monkeypatch):
    """``solve_from_boundary_stream`` moves its data through
    ``tracing.to_host``/``to_device``: the counters see, per effective field,
    the block's float64 values up and its float64 field down, and per solve
    the right-hand side up and the solution down in the solve dtype."""
    import importlib

    # The module: ``solver.solve_film`` is the function once the package is imported.
    solve_film = importlib.import_module("superscreen_tpu_torch.solver.solve_film")
    model, device = transport["model"], transport["device"]
    info, systems = model.film_info["strip"], model.terminal_systems["strip"]
    g = np.zeros(len(device.meshes["strip"].sites))
    g[info.boundary_indices] = np.linspace(-1.0, 1.0, len(info.boundary_indices))
    moved = {"up": 0, "down": 0}
    to_host, to_device = tracing.to_host, tracing.to_device

    def host(t):
        moved["down"] += t.numel() * t.element_size()
        return to_host(t)

    def card(value, device, dtype=None):
        out = to_device(value, device, dtype)
        moved["up"] += out.numel() * out.element_size()
        return out

    want = solve_film.solve_from_boundary_stream(device, info, systems, g)
    monkeypatch.setattr(tracing, "to_host", host)
    monkeypatch.setattr(tracing, "to_device", card)
    got = solve_film.solve_from_boundary_stream(device, info, systems, g)
    assert np.array_equal(got, want)
    n = len(g)
    size = info.weights.element_size()
    blocks = [systems.boundary, *systems.holes.values(), systems.boundary]
    solved = [systems.film_without_boundary, systems.film_without_boundary_or_holes]
    assert moved["up"] == sum(8 * len(b.indices) for b in blocks) + sum(size * len(s.indices) for s in solved)
    assert moved["down"] == 8 * n * len(blocks) + sum(size * len(s.indices) for s in solved)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _profiled_sweep_on_the_card():
    """A small ``solve_many`` on the card under a host and device profile:
    the counters, the spans that counted, each film's sites and holes, and
    the device events' names (run by the test below in a process of its
    own)."""
    device = _two_rings()
    model = st.factorize_model(
        device=device, current_units="uA", circulating_currents={"big_hole": 2.0}, torch_device="cuda"
    )
    fields = [st.sources.ConstantField(b) for b in FIELDS]
    st.solve_many(model=model, applied_fields=fields, iterations=ITERATIONS, torch_device="cuda")
    with _profiled((ProfilerActivity.CPU, ProfilerActivity.CUDA)) as prof:
        st.solve_many(model=model, applied_fields=fields, iterations=ITERATIONS, torch_device="cuda")
    snap = tracing.snapshot()
    return dict(
        counters=snap["counters"],
        counted=sorted({s.name for s in snap["spans"] if s.counts}),
        sites={name: len(mesh.sites) for name, mesh in device.meshes.items()},
        holes={name: len(info.hole_indices) for name, info in model.film_info.items()},
        device_events=sorted({
            e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
        }),
    )


@pytest.mark.gpu
def test_transfer_counters_of_a_sweep_on_the_card(cuda):
    """Copies of a small ``solve_many`` against the bytes its shapes give:
    up, each film's ``(B, n)`` applied field and ``(B, n_holes)`` currents;
    down, its streams, self-fields, fields from other films and applied
    fields ``(B, n)`` and current densities ``(B, n, 2)``, one blocking
    copy each; and no device event carries a program span's name.  The
    profile runs in a process of its own: after it, a later device-only
    profile in the same process recorded no device events on the card
    (torch 2.11), and other tests of the card profile that way."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    code = (
        f"import json, sys; sys.path[:0] = [{str(here.parent)!r}, {str(here)!r}]; "
        "import test_torch_tracing as t; print(json.dumps(t._profiled_sweep_on_the_card()))"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    B, size, sites, holes = len(FIELDS), 4, got["sites"], got["holes"]
    assert got["counters"] == {
        "h2d_bytes": sum(B * (sites[f] + holes[f]) * size for f in sites),
        "d2h_bytes": sum(6 * B * sites[f] * size for f in sites),
        "host_syncs": 5 * len(sites),
        "triangular_solves": SWEEP_SOLVES,
    }
    assert got["counted"] == ["sweep.film_solve", "sweep.inputs", "sweep.to_host"]
    assert got["device_events"] and not set(got["device_events"]) & PROGRAM_SPANS


def _profiled_transport_sweep_on_the_card():
    """The driven sweep of the terminal strip on the card under a host and
    device profile: the counters and the sizes they derive from (run by the
    test below in a process of its own)."""
    device = _terminal_strip()
    vortices = [st.Vortex(x=1.2, y=0.4, film="strip"), st.Vortex(x=-0.5, y=-0.8, film="strip")]
    model = st.factorize_model(device=device, current_units="uA", vortices=vortices, torch_device="cuda")
    fields = [st.sources.ConstantField(b) for b in FIELDS]
    drive = dict(
        terminal_currents=[{"strip": {"source": I, "drain": -I}} for I in (1.0, 2.5, 4.0)],
        vortex_nPhi0=np.array([[1.0, 0.0], [-1.0, 2.0], [0.0, -2.0]]),
    )
    st.solve_many(model=model, applied_fields=fields, torch_device="cuda", **drive)
    with _profiled((ProfilerActivity.CPU, ProfilerActivity.CUDA)):
        st.solve_many(model=model, applied_fields=fields, torch_device="cuda", **drive)
    info, systems = model.film_info["strip"], model.terminal_systems["strip"]
    return dict(
        counters=tracing.snapshot()["counters"],
        n=len(device.meshes["strip"].sites),
        boundary=len(info.boundary_indices),
        holes=[len(h.indices) for h in systems.holes.values()],
        solved=[len(systems.film_without_boundary.indices), len(systems.film_without_boundary_or_holes.indices)],
    )


@pytest.mark.gpu
def test_transfer_counters_of_a_transport_sweep_on_the_card(cuda):
    """The copies of a driven sweep of the terminal strip against its
    shapes: the inputs and results as a plain sweep's, the vortex
    amplitudes up, and for each of the two unit bootstrap solutions the
    copies of ``solve_from_boundary_stream`` (float64 block values up and
    fields down, the right-hand sides up and the solutions down) and of
    its boundary field (the geometry up, the field down), then the
    per-point offsets up."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    code = (
        f"import json, sys; sys.path[:0] = [{str(here.parent)!r}, {str(here)!r}]; "
        "import test_torch_tracing as t; print(json.dumps(t._profiled_transport_sweep_on_the_card()))"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    B, size, n, nb = len(FIELDS), 4, got["n"], got["boundary"]
    holes, solved = got["holes"], got["solved"]
    units = 2
    bootstrap_up = 8 * (2 * nb + sum(holes)) + size * sum(solved)
    bootstrap_down = 8 * n * (2 + len(holes)) + size * sum(solved)
    boundary_field_up = size * (2 * n + 2 * nb + nb + 2 * nb + nb)
    assert got["counters"] == {
        "h2d_bytes": size * B * (n + len(holes)) + size * B * 2
        + units * (bootstrap_up + boundary_field_up) + 2 * size * B * n,
        "d2h_bytes": 6 * B * n * size + units * (bootstrap_down + size * n),
        "host_syncs": 5 + units * (2 + len(holes) + 2 + 1),
        "terminal_solves": units * 2,
        "triangular_solves": units * 2 * REFINED + REFINED,
    }

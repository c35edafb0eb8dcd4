"""The transport stack (``transport_sweep``) on the CPU, on a small copy of
``transport_stack`` (the strip's polygons redrawn at a few hundred sites by
the configuration's own drawing code, both films meshed by the program):
the port in float64 against ``reference/transport.py`` on seeded drives,
the reference's terminal drive whatever the start of its boundary walk, the
TF32 control against the file's limits, a sound run and planted faults
through ``run_cell``."""

import copy
import json
import time

import numpy as np
import pytest

import superscreen_tpu_torch as st

from benchmark import harness
from benchmark.devices import build_device, sha256
from benchmark.reference import films as ref
from benchmark.reference import transport


def config(name: str) -> dict:
    return json.loads((harness.ROOT / "benchmark" / "configs" / f"{name}.json").read_text())

#: Sites per film of the small copy.
SITES = {"strip": 300, "ring": 300}
SEED = 2**31 + 77


def small_transport(out_dir, dtype=None) -> dict:
    """``transport_stack`` with the strip's outline, hole and terminals
    redrawn for :data:`SITES` (``entries/transport_sweep.strip_polygons``),
    meshed by the program, its mesh files under ``out_dir``."""
    cfg = copy.deepcopy(config("transport_stack"))
    if dtype:
        cfg["solve_dtype"] = dtype
    spec = cfg["devices"]["stack"]
    drawn = {k: v.tolist() for k, v in harness._module("entries", "transport_sweep", harness.ROOT)
             .strip_polygons(st, SITES["strip"]).items()}
    for p in spec["films"] + spec["holes"] + [t for f in spec["films"] for t in f.get("terminals", [])]:
        if p["name"] in drawn:
            p["points"] = drawn[p["name"]]
    spec["mesh"] = {"min_points": dict(SITES)}
    device = build_device(st, "stack", spec, cfg["solve_dtype"], meshed=False)
    device.make_mesh(**spec["mesh"])
    for film, mesh in device.meshes.items():
        path = out_dir / f"transport_{film}.npz"
        np.savez_compressed(path, sites=mesh.sites, elements=mesh.elements.astype(np.int32))
        spec["files"][film] = {"file": str(path), "sha256": sha256(path)}
    return cfg


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    cache = {}

    def get(dtype=None):
        if dtype not in cache:
            cache[dtype] = small_transport(tmp_path_factory.mktemp(f"transport_{dtype}"), dtype)
        return cache[dtype]

    return get


def cell():
    return harness.cell_inputs(harness.load_bench(), "transport_sweep")


def entry_for(cfg):
    _, _, traffic, _, _ = cell()
    return harness.entry_class(traffic["entry"])(cfg, traffic, ["cpu"])


def draws(entry, seed, calls):
    rng = np.random.default_rng([seed, 0])
    return [entry.draw(rng) for _ in range(calls)]


def test_the_port_meets_the_reference_in_float64(small):
    entry = entry_for(small("float64"))
    entry.setup(st)
    reference = entry.reference(ref.F64, "cpu")
    params = draws(entry, SEED, 3)
    for p in params:
        errors = entry.errors(entry.call(p), reference.sweep(p))
        assert errors["stream_rel_err"] < 1e-8 and errors["self_field_rel_err"] < 1e-8, errors


def test_the_terminal_drive_does_not_depend_on_where_the_walk_starts(small):
    """The reference's boundary stream with its walk started anywhere that
    leaves each terminal whole (right after either terminal, or on a vertex
    of a long side) is the same on the boundary (the centring moves the
    interior's zeros too, and the solves overwrite them)."""
    entry = entry_for(small("float64"))
    strip = next(f for f in entry.reference(ref.F64, "cpu").films if f.terminals)
    drive = {"source": 3.0, "drain": -3.0}
    want = strip.boundary_stream(drive)
    walk = strip.walk
    on = np.any([transport.points_in_ring(transport.closed_ccw(ring), strip.film.sites[walk])
                 for ring in strip.terminals.values()], axis=0)
    starts = np.flatnonzero(~on & np.roll(on, 1))
    sides = np.flatnonzero(~on & ~np.roll(on, 1))
    assert len(starts) == 2 and len(sides) > 10
    for start in [*starts, *sides[:: len(sides) // 5]]:
        strip.walk = np.roll(walk, -start)
        np.testing.assert_allclose(strip.boundary_stream(drive)[walk], want[walk], rtol=0, atol=1e-12)
    strip.walk = walk
    # The drive enters at the source and leaves at the drain: the stream
    # steps by the bias across each terminal and is flat elsewhere.
    assert np.ptp(want[walk]) == pytest.approx(3.0)


def test_the_tf32_control_fails_the_limits(small):
    cfg = small()
    entry = entry_for(cfg)
    for errors in entry.control_errors(draws(entry, SEED, 2), "cpu"):
        for name, limit in cfg["limits"].items():
            assert errors[name] > limit, (name, errors[name], limit)


def run(cfg, seconds=0.6):
    cell_, _, traffic, per_layer, e2e = cell()
    result, failures, found, _ = harness.run_cell(
        cell_, cfg, traffic, per_layer, e2e, SEED, seconds, 0, "cpu", time.perf_counter()
    )
    assert not found
    return result


def test_a_sound_run_is_correct(small):
    result = run(small())
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == {"stream_rel_err", "self_field_rel_err"}


def drive_zeroed(monkeypatch):
    """The bias sweep's terminal currents replaced by zeros."""
    from superscreen_tpu_torch import sweep

    fn = sweep._apply_terminal_sweeps

    def broken(model, film_data, terminal_currents, B, current_units):
        zero = [{f: dict.fromkeys(c, 0.0) for f, c in tc.items()} for tc in terminal_currents]
        return fn(model, film_data, zero, B, current_units)

    monkeypatch.setattr(sweep, "_apply_terminal_sweeps", broken)


def vortices_dropped(monkeypatch):
    """The vortices' part of the interior stream left out."""
    import torch

    from superscreen_tpu_torch import sweep

    fn = sweep._vortex_term
    monkeypatch.setattr(sweep, "_vortex_term", lambda data, flux: torch.zeros_like(fn(data, flux)))


def lambda_uniform(monkeypatch):
    """Each film's Lambda made uniform at its smallest value."""
    from superscreen_tpu_torch.solver import utils

    fn = utils._sample_depth

    def broken(value, sites, dtype):
        profile = fn(value, sites, dtype)
        return np.full_like(profile, profile.min())

    monkeypatch.setattr(utils, "_sample_depth", broken)


@pytest.mark.parametrize("fault", [drive_zeroed, vortices_dropped, lambda_uniform], ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(small, monkeypatch, fault):
    fault(monkeypatch)
    result = run(small())
    assert result["correct"] is False
    assert all(c["value"] > c["limit"] for c in result["checks"].values()), result["checks"]


def test_the_configuration_file_keeps_the_scalar_base_and_its_weak_spots():
    """``build_device`` and the meshing read each layer's scalar ``Lambda``;
    the weak spot is a key of its own, read by the entry and the reference."""
    cfg = config("transport_stack")
    layers = cfg["devices"]["stack"]["layers"]
    assert all(isinstance(l["Lambda"], float) and set(l["weak_spot"]) == {"x0", "y0", "sigma", "depth"}
               for l in layers)
    sites = np.array([[2.0, 1.0], [-3.0, 4.0], [40.0, 40.0]])
    base, top = (transport.lambda_at(sites, l) for l in layers)
    np.testing.assert_allclose(base, [1.5, 1.0 * (1 + 0.5 * np.exp(-34 / 8)), 1.0], rtol=1e-15)
    np.testing.assert_allclose(top, [0.5 * (1 + 0.5 * np.exp(-34 / 8)), 0.75, 0.5], rtol=1e-15)
    assert json.dumps(cfg["reduced"]) == "[]"


def test_the_terminal_readers_on_a_made_up_snapshot(monkeypatch):
    """``terminals_ms.point`` sums the closed ``sweep.terminals`` spans and
    ``terminal_solves.point`` reads its counter, per point; each reads
    nothing where the program recorded nothing (a parent without them)."""
    from types import SimpleNamespace

    from superscreen_tpu_torch import tracing

    ms = 1_000_000
    spans = [tracing.Span("sweep.terminals", 0, 6 * ms, None, 0), tracing.Span("sweep.terminals", 9 * ms, 11 * ms, None, 0),
             tracing.Span("sweep.vortices", 11 * ms, 12 * ms, None, 0), tracing.Span("sweep.terminals", 20 * ms, None, None, 0)]
    ctx = SimpleNamespace(points=16, calls=2)
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": spans, "counters": {"terminal_solves": 8}})
    assert harness.layer_reader("terminals_ms.point")(ctx) == pytest.approx(8 / 16)
    assert harness.layer_reader("terminal_solves.point")(ctx) == pytest.approx(0.5)
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": [], "counters": {"host_syncs": 3}})
    for name in ("terminals_ms.point", "terminal_solves.point"):
        assert harness.layer_reader(name)(ctx) is None

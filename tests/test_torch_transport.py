"""Transport terminals in the port against the JAX package: boundary index
sets, the terminal systems, the bootstrap stream, the boundary and in-film
fields, ``solve()`` with terminal currents and the bias sweep, on the same
meshes (through ``device_from_reference``) at float64 on the CPU."""

import importlib

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.device.device import _unwrap_terminals as ref_unwrap_terminals
from superscreen_tpu.ops import kernels as ref_kernels
from superscreen_tpu.solver import utils as ref_utils
from superscreen_tpu.sweep import _terminal_boundary_ha as ref_terminal_boundary_ha
from superscreen_tpu.sweep import solve_many as ref_solve_many
from superscreen_tpu_torch.device.device import _unwrap_terminals
from superscreen_tpu_torch.ops import kernels
from superscreen_tpu_torch.solver import utils as port_utils
from superscreen_tpu_torch.sweep import _terminal_boundary_ha, relative_residual

ref_sf = importlib.import_module("superscreen_tpu.solver.solve_film")
port_sf = importlib.import_module("superscreen_tpu_torch.solver.solve_film")

torch.set_num_threads(2)

# float64 on both sides; LU pivoting and summation orders differ, which
# costs a few ulp times the systems' condition numbers (~1e3-1e4).
RTOL = 1e-8
FIELDS = ["stream", "current_density", "applied_field", "self_field"]


def _strip():
    """The strip with source and drain of tests/test_sweep.py."""
    film = sc.Polygon("strip", layer="base", points=sc.geometry.box(4, 2, points=40))
    src = sc.Polygon("source", points=sc.geometry.box(0.2, 2, points=16, center=(-2, 0)))
    drain = sc.Polygon("drain", points=sc.geometry.box(0.2, 2, points=16, center=(2, 0)))
    device = sc.Device(
        "strip", layers=[sc.Layer("base", Lambda=1)], films=[film],
        terminals={"strip": [src, drain]}, solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.5)
    drive = {"strip": {"source": 3.0, "drain": -3.0}}
    return device, dict(terminal_currents=drive)


def _plus():
    """The four-terminal plus of tests/test_transport.py, meshed coarser."""
    width, height = 10, 2
    bar = sc.Polygon("plus", points=sc.geometry.box(width, height))
    plus = bar.union(bar.rotate(90)).resample(251)
    plus.name, plus.layer = "plus", "base"
    terminal = sc.Polygon(points=sc.geometry.box(height, width / 100, center=(0, -width / 2)))
    terminals = []
    for i, name in enumerate(["drain", "source1", "source2", "source3"]):
        term = terminal.rotate(i * 90)
        term.name = name
        terminals.append(term)
    device = sc.Device(
        "plus", films=[plus], layers=[sc.Layer("base", Lambda=1)],
        terminals={"plus": terminals}, solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.6)
    drive = {"plus": {"drain": -6, "source1": "1 uA", "source2": 2.0, "source3": 3}}
    return device, dict(terminal_currents=drive)


def _holey():
    """The two-hole constriction of tests/test_transport.py, meshed coarser."""
    width, height = 1, 2
    slot = (width / 4, height / 5)
    film = (
        sc.Polygon("film", layer="base", points=sc.geometry.box(width, height))
        .difference(sc.geometry.box(*slot, center=(-(width - slot[0]) / 2, 0)))
        .difference(sc.geometry.box(*slot, center=(+(width - slot[0]) / 2, 0)))
        .resample(201)
    )
    source = sc.Polygon(
        "source", points=sc.geometry.box(width, height / 100, center=(0, height / 2))
    )
    drain = sc.Polygon(
        "drain", points=sc.geometry.box(width, height / 100, center=(0, -height / 2))
    )
    holes = [
        sc.Polygon("hole1", layer="base", points=sc.geometry.circle(width / 4, center=(0, height / 4))),
        sc.Polygon("hole2", layer="base", points=sc.geometry.circle(width / 4, center=(0, -height / 4))),
    ]
    device = sc.Device(
        "constriction", layers=[sc.Layer("base", Lambda=2)], films=[film], holes=holes,
        terminals={"film": [source, drain]}, solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.12)
    return device, dict(
        terminal_currents={"film": {"source": "2 uA", "drain": "-2 uA"}},
        circulating_currents={"hole1": "1 uA", "hole2": "-1 uA"},
    )


_DEVICES = {"strip": _strip, "plus": _plus, "holey": _holey}


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module", params=sorted(_DEVICES))
def case(request):
    ref, kwargs = _DEVICES[request.param]()
    port = st.device_from_reference(ref)
    film = next(iter(ref.films))
    ref_model = sc.factorize_model(device=ref, current_units="uA", **kwargs)
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu", **kwargs)
    return dict(ref=ref, port=port, film=film, kwargs=kwargs, ref_model=ref_model, model=model)


def test_meshes_are_small(case):
    assert all(50 < len(m.sites) < 2500 for m in case["ref"].meshes.values())


def test_terminals_are_carried_over(case):
    ref, port, film = case["ref"], case["port"], case["film"]
    assert list(port.terminals) == [film]
    for a, b in zip(ref.terminals[film], port.terminals[film]):
        assert (b.name, b.layer) == (a.name, a.layer) and b.layer == port.films[film].layer
        np.testing.assert_array_equal(b.points, a.points)
    clone = port.copy()
    assert [t.name for t in clone.terminals[film]] == [t.name for t in port.terminals[film]]
    assert clone.terminals[film][0] is not port.terminals[film][0]
    assert [p.name for p in port.polygons_by_layer("terminal")["base"]] == [
        t.name for t in ref.terminals[film]
    ]


def test_boundary_vertices_and_terminal_index_sets_match(case):
    ref, port, film = case["ref"], case["port"], case["film"]
    boundary = port.boundary_vertices(film)
    np.testing.assert_array_equal(boundary, ref.boundary_vertices(film))
    sites = port.meshes[film].sites
    for a, b in zip(ref.terminals[film], port.terminals[film]):
        own = b.contains_points(sites[boundary], index=True)
        np.testing.assert_array_equal(own, a.contains_points(sites[boundary], index=True))
        # No terminal straddles the wrap point of the cycle.
        assert len(own) > 1 and np.all(np.diff(own) == 1)


def test_boundary_roll_wrap(case):
    """A cycle that starts inside a terminal is rolled exactly as the JAX
    package rolls it."""
    ref, port, film = case["ref"], case["port"], case["film"]
    sites = port.meshes[film].sites
    base = port.boundary_vertices(film)
    for a, b in zip(ref.terminals[film], port.terminals[film]):
        pos = b.contains_points(sites[base], index=True)
        wrapped = np.roll(base, -pos[len(pos) // 2])
        fixed = _unwrap_terminals(wrapped, sites, [b])
        np.testing.assert_array_equal(fixed, ref_unwrap_terminals(wrapped, sites, [a]))
        assert np.all(np.diff(b.contains_points(sites[fixed], index=True)) == 1)


def test_film_info_matches(case):
    ref_info = case["ref_model"].film_info[case["film"]]
    info = case["model"].film_info[case["film"]]
    for key in ("interior_indices", "boundary_indices", "in_hole"):
        np.testing.assert_array_equal(getattr(info, key), getattr(ref_info, key))
    assert info.dense_kernel and info.terminal_currents == ref_info.terminal_currents
    assert case["model"].terminal_currents == case["ref_model"].terminal_currents


@pytest.mark.parametrize(
    "block", ["boundary", "film_without_boundary", "film_without_boundary_or_holes", "holes"]
)
def test_terminal_system_blocks_match(case, block):
    film = case["film"]
    ref_ts = case["ref_model"].terminal_systems[film]
    ts = case["model"].terminal_systems[film]
    assert ts.film == film
    pairs = (
        [(ts.holes[h], ref_ts.holes[h]) for h in ref_ts.holes]
        if block == "holes"
        else [(getattr(ts, block), getattr(ref_ts, block))]
    )
    if block == "holes":
        assert set(ts.holes) == set(ref_ts.holes)
    for system, ref_system in pairs:
        if ref_system is None:
            assert system is None
            continue
        np.testing.assert_array_equal(system.indices, ref_system.indices)
        A_ref = np.asarray(ref_system.A)
        assert _max_rel(system.A.numpy(), A_ref) <= 1e-12
        assert (system.lu_piv is None) == (ref_system.lu_piv is None)
    # The film's main system is the terminal block's interior system.
    main = case["model"].film_systems[film]
    assert main is (ts.film_without_boundary_or_holes or ts.film_without_boundary)


def test_terminal_current_stream_matches(case):
    film = case["film"]
    ref_model, model = case["ref_model"], case["model"]
    g_ref = ref_sf.solve_for_terminal_current_stream(
        ref_model.device, ref_model.film_info[film], ref_model.terminal_systems[film],
        ref_model.terminal_currents[film],
    )
    g = port_sf.solve_for_terminal_current_stream(
        model.device, model.film_info[film], model.terminal_systems[film],
        model.terminal_currents[film],
    )
    assert g.shape == g_ref.shape and _max_rel(g, g_ref) <= RTOL
    zero = port_sf.solve_for_terminal_current_stream(
        model.device, model.film_info[film], model.terminal_systems[film], {}
    )
    assert zero.shape == g.shape and not zero.any()
    raw_ref = ref_sf.terminal_boundary_stream(
        ref_model.device, ref_model.film_info[film], ref_model.terminal_systems[film],
        ref_model.terminal_currents[film],
    )
    raw = port_sf.terminal_boundary_stream(
        model.device, model.film_info[film], model.terminal_systems[film],
        model.terminal_currents[film],
    )
    assert _max_rel(raw, raw_ref) <= 1e-13
    data = model.film_data[film]
    assert data.terminal and data.Qw is None
    assert _max_rel(data.g_offset.numpy(), g_ref) <= RTOL
    ha_ref = ref_terminal_boundary_ha(
        ref_model.device.meshes[film].sites, ref_model.film_info[film].boundary_indices, g_ref
    )
    assert _max_rel(data.ha_offset.numpy(), ha_ref) <= RTOL
    ha = _terminal_boundary_ha(
        model.device.meshes[film].sites, model.film_info[film].boundary_indices, g_ref, data.weights
    )
    assert _max_rel(ha, ha_ref) <= 1e-12


@pytest.mark.parametrize("current", [0.0, 2.5])
def test_stream_from_terminal_current_matches(current):
    rng = np.random.default_rng(11)
    points = np.cumsum(rng.uniform(0.1, 1.0, (9, 2)), axis=0)
    a = ref_utils.stream_from_terminal_current(points, current)
    b = port_utils.stream_from_terminal_current(points, current)
    assert b.shape == a.shape == (8,)
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=0)
    J = rng.standard_normal((8, 2))
    np.testing.assert_allclose(
        port_utils.stream_from_current_density(points, J),
        ref_utils.stream_from_current_density(points, J), rtol=1e-14,
    )


def test_boundary_effective_field_matches_on_seeded_inputs():
    rng = np.random.default_rng(3)
    sites = rng.uniform(-3, 3, (257, 2))
    centers = rng.uniform(-4, 4, (41, 2)) + 10.0
    lengths = rng.uniform(0.1, 0.3, 41)
    normals = rng.standard_normal((41, 2))
    stream = rng.standard_normal(41)
    ref = np.asarray(ref_kernels.boundary_effective_field(sites, centers, lengths, normals, stream))
    out = kernels.boundary_effective_field(
        *(torch.as_tensor(a) for a in (sites, centers, lengths, normals, stream)), block=100
    )
    assert out.dtype == torch.float64 and out.shape == (257,)
    assert _max_rel(out.numpy(), ref) <= 1e-13


@pytest.mark.parametrize("B", [None, 1, 3])
def test_biot_savart_within_film_matches_on_seeded_inputs(B):
    rng = np.random.default_rng(5)
    sites = rng.uniform(-3, 3, (211, 2))
    centroids = rng.uniform(-3, 3, (389, 2))
    areas = rng.uniform(0.01, 0.05, 389)
    J = rng.standard_normal((389, 2) if B is None else (B, 389, 2))
    ref = np.asarray(ref_kernels.biot_savart_within_film(sites, centroids, areas, J))
    out = kernels.biot_savart_within_film(*(torch.as_tensor(a) for a in (sites, centroids, areas, J)))
    assert out.shape == ref.shape == ((211,) if B is None else (B, 211))
    assert _max_rel(out.numpy(), ref) <= 1e-13


def test_biot_savart_within_film_on_a_mesh_matches(case):
    """On a mesh the sources are the triangle centroids, which never
    coincide with a site: the JAX function's r = 0 guard is idle."""
    film = case["film"]
    mesh, ref_mesh = case["port"].meshes[film], case["ref"].meshes[film]
    np.testing.assert_allclose(mesh.triangle_centroids, ref_mesh.triangle_centroids, rtol=1e-15)
    for axis in "xy":
        a = getattr(ref_mesh.operators, f"gradient_tri_{axis}")
        b = getattr(mesh.operators, f"gradient_tri_{axis}")
        assert b.shape == a.shape == (len(mesh.elements), len(mesh.sites))
        np.testing.assert_array_equal(b.rows, a.rows)
        np.testing.assert_array_equal(b.cols, a.cols)
        np.testing.assert_allclose(b.vals, a.vals, rtol=1e-14)
    J = np.random.default_rng(2).standard_normal((2, len(mesh.elements), 2))
    ref = np.asarray(
        ref_kernels.biot_savart_within_film(
            ref_mesh.sites, ref_mesh.triangle_centroids, ref_mesh.triangle_areas, J
        )
    )
    out = kernels.biot_savart_within_film(
        *(torch.as_tensor(a) for a in (mesh.sites, mesh.triangle_centroids, mesh.triangle_areas, J))
    )
    assert _max_rel(out.numpy(), ref) <= 1e-13


@pytest.mark.parametrize("field", FIELDS)
def test_solve_with_terminal_currents_matches_jax(case, field):
    applied = 0.1
    ref_solution = sc.solve(
        model=case["ref_model"], applied_field=sc.sources.ConstantField(applied),
        progress_bar=False,
    )[-1]
    solution = st.solve(
        model=case["model"], applied_field=st.sources.ConstantField(applied), torch_device="cpu"
    )[-1]
    film = case["film"]
    a = getattr(ref_solution.film_solutions[film], field)
    b = getattr(solution.film_solutions[film], field)
    assert b.shape == a.shape and b.dtype == np.float64
    assert _max_rel(b, a) <= RTOL, (field, _max_rel(b, a))
    assert solution.terminal_currents == ref_solution.terminal_currents


def test_solve_from_a_device_and_residual(case):
    film = case["film"]
    solution = st.solve(
        case["port"], applied_field=st.sources.ConstantField(0.1), torch_device="cpu",
        **case["kwargs"],
    )[-1]
    from_model = st.solve(
        model=case["model"], applied_field=st.sources.ConstantField(0.1), torch_device="cpu"
    )[-1]
    fs = solution.film_solutions[film]
    assert _max_rel(fs.stream, from_model.film_solutions[film].stream) <= 1e-12
    model = case["model"]
    data = model.film_data[film]
    conv = st.solver.field_conversion_factor("mT", "uA", length_units="um").magnitude
    I_circ = [[model.circulating_currents.get(h, 0.0) for h in data.hole_names]]
    res = relative_residual(
        data,
        torch.as_tensor(fs.applied_field[None] * conv),
        torch.as_tensor(I_circ, dtype=torch.float64).reshape(1, len(data.hole_names)),
        torch.as_tensor(fs.stream[None]),
    )
    assert float(res[0]) < 1e-10


def _bias_drives(case):
    names = [t.name for t in case["port"].terminals[case["film"]]]
    first = {name: 0.0 for name in names}
    first[names[0]], first[names[-1]] = 1.0, -1.0
    second = {name: f"{c} uA" for name, c in zip(names, np.linspace(-2, 2, len(names)))}
    second[names[-1]] = f"{-sum(np.linspace(-2, 2, len(names))[:-1])} uA"
    return [{case["film"]: first}, {case["film"]: second}, {}]


@pytest.mark.parametrize("quantity", ["streams", "current_densities", "self_fields"])
def test_bias_sweep_matches_jax(case, quantity):
    """A terminal-current sweep with a string current and an undriven
    point, on a model factorized with another drive."""
    drives = _bias_drives(case)
    circ = case["kwargs"].get("circulating_currents")
    extra = dict(circulating_currents=[circ, {}, circ]) if circ else {}
    ref = ref_solve_many(
        model=case["ref_model"], applied_fields=[sc.sources.ConstantField(0.1)] * 3,
        terminal_currents=drives, **extra,
    )
    result = st.solve_many(
        model=case["model"], applied_fields=[st.sources.ConstantField(0.1)] * 3,
        terminal_currents=drives, torch_device="cpu", **extra,
    )
    film = case["film"]
    a, b = np.asarray(getattr(ref, quantity)[film]), getattr(result, quantity)[film]
    assert b.shape == a.shape and _max_rel(b, a) <= RTOL
    for i in range(3):
        assert result.solution(i).terminal_currents == ref.solution(i).terminal_currents
    assert result.solution(2).terminal_currents == {}


def test_bias_sweep_point_matches_the_port_solve(case):
    drives = _bias_drives(case)
    film = case["film"]
    result = st.solve_many(
        model=case["model"], applied_fields=[st.sources.ConstantField(0.1)] * 3,
        terminal_currents=drives, torch_device="cpu",
    )
    for i, drive in enumerate(drives):
        solution = st.solve(
            case["port"], terminal_currents=drive or None,
            circulating_currents=case["kwargs"].get("circulating_currents"),
            applied_field=st.sources.ConstantField(0.1), torch_device="cpu",
        )[-1]
        assert _max_rel(result.streams[film][i], solution.film_solutions[film].stream) <= 1e-9


@pytest.mark.parametrize(
    "drives, n_fields, match",
    [
        ([{"FILM": {"FIRST": 1.0, "LAST": 0.0}}], 1, "sum to zero"),
        ([{"FILM": {"FIRST": 1.0, "LAST": -1.0}}] * 3, 2, "length"),
        ([{"nope": {"a": 1.0}}], 1, "terminals"),
        ([{"FILM": {"nope": 1.0, "LAST": -1.0}}], 1, "Unknown terminals"),
    ],
)
def test_bias_sweep_validation(case, drives, n_fields, match):
    names = [t.name for t in case["port"].terminals[case["film"]]]
    swap = {"FILM": case["film"], "FIRST": names[0], "LAST": names[-1]}
    drives = [
        {swap.get(f, f): {swap.get(t, t): c for t, c in cur.items()} for f, cur in d.items()}
        for d in drives
    ]
    with pytest.raises(ValueError, match=match):
        st.solve_many(
            model=case["model"], applied_fields=[st.sources.ConstantField(0.1)] * n_fields,
            terminal_currents=drives, torch_device="cpu",
        )


@pytest.mark.parametrize(
    "terminal_currents, error",
    [
        ({"nope": {"source": 1.0}}, KeyError),
        ({"strip": {"nope": 1.0, "drain": -1.0}}, KeyError),
        ({"strip": {"source": 1.0, "drain": -0.5}}, ValueError),
    ],
)
def test_factorize_rejects_bad_terminal_currents(terminal_currents, error):
    ref, _ = _strip()
    port = st.device_from_reference(ref)
    with pytest.raises(error):
        st.factorize_model(
            device=port, current_units="uA", terminal_currents=terminal_currents,
            torch_device="cpu",
        )
    with pytest.raises(error):
        sc.factorize_model(device=ref, current_units="uA", terminal_currents=terminal_currents)


def test_terminal_film_keeps_a_dense_kernel_at_any_size(monkeypatch):
    ref, kwargs = _strip()
    port = st.device_from_reference(ref)
    monkeypatch.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    info = port_utils.make_film_info(device=port, circulating_currents={}, torch_device="cpu")
    n = len(port.meshes["strip"].sites)
    assert info["strip"].dense_kernel and info["strip"].kernel.shape == (n, n)


def test_port_meshes_a_terminal_film_with_its_boundary_preserved():
    film = st.Polygon("strip", layer="base", points=st.geometry.box(4, 2, points=40))
    src = st.Polygon("source", points=st.geometry.box(0.2, 2, points=16, center=(-2, 0)))
    drain = st.Polygon("drain", points=st.geometry.box(0.2, 2, points=16, center=(2, 0)))
    device = st.Device(
        "strip", layers=[st.Layer("base", Lambda=1)], films=[film],
        terminals={"strip": [src, drain]}, solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.5)
    mesh = device.meshes["strip"]
    boundary = device.boundary_vertices("strip")
    # No vacuum margin and no added boundary vertices: the mesh boundary is
    # the polygon's own ring.
    ring = film.points[:-1]
    assert len(boundary) == len(ring)
    assert {tuple(p) for p in np.round(mesh.sites[boundary], 12)} == {
        tuple(p) for p in np.round(ring, 12)
    }
    solution = st.solve(
        device, terminal_currents={"strip": {"source": 3.0, "drain": -3.0}}, torch_device="cpu"
    )[-1]
    g = solution.film_solutions["strip"].stream
    top, bottom = (np.isclose(mesh.sites[:, 1], y) for y in (1.0, -1.0))
    # The stream on the two long edges differs by the drive current.
    assert np.ptp(g[top]) < 1e-9 and np.ptp(g[bottom]) < 1e-9
    assert abs(abs(g[top][0] - g[bottom][0]) - 3.0) < 1e-9
    with pytest.raises(ValueError, match="subset"):
        st.Device("d", layers=[st.Layer("base", Lambda=1)], films=[film], terminals={"nope": [src]})

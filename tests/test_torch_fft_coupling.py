"""The port's FFT inter-film coupling (``ops.fft_coupling``) and the
``coupling`` dispatch of ``solve``/``solve_many`` against the JAX
package's, at float64 on the CPU through ``device_from_reference``."""

import matplotlib.tri as mtri
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu import sweep as ref_sweep
from superscreen_tpu.ops import fft_coupling as ref_fft
from superscreen_tpu_torch import sweep as port_sweep
from superscreen_tpu_torch.ops import fft_coupling as port_fft

torch.set_num_threads(2)

# Same float64 operators on both sides: interpolation data to rounding,
# transforms to the FFT libraries' rounding.
GRID_RTOL = 1e-12
SPECTRUM_RTOL = 1e-10
# Whole solves: LU pivoting and summation orders differ by a few ulp
# times the systems' condition numbers.
SOLVE_RTOL = 1e-8


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _stacked_disks():
    """The two stacked disks of tests/test_solve_coupling.py, meshed
    coarser."""
    layers = [sc.Layer("layer0", Lambda=1.0, z0=0), sc.Layer("layer1", Lambda=0.5, z0=1.0)]
    films = [
        sc.Polygon("disk0", layer="layer0", points=geo.circle(5.0, points=60)),
        sc.Polygon("disk1", layer="layer1", points=geo.circle(4.0, points=50)),
    ]
    device = sc.Device("stack", layers=layers, films=films, solve_dtype="float64")
    device.make_mesh(max_edge_length=0.9)
    return device


def _two_rings():
    """The two rings of tests/test_sweep.py, one circulating current each."""
    layers = [sc.Layer("layer0", Lambda=1, z0=0), sc.Layer("layer1", Lambda=1, z0=1)]
    films = [
        sc.Polygon("big_ring", layer="layer0", points=geo.circle(7.5, points=80)),
        sc.Polygon("little_ring", layer="layer1", points=geo.circle(5, points=60)),
    ]
    holes = [
        sc.Polygon("big_hole", layer="layer0", points=geo.circle(3.75, points=40)),
        sc.Polygon("little_hole", layer="layer1", points=geo.circle(2.5, points=30)),
    ]
    device = sc.Device("two_rings", layers=layers, films=films, holes=holes, solve_dtype="float64")
    device.make_mesh(max_edge_length=1.0)
    return device


@pytest.fixture(scope="module")
def disks():
    ref = _stacked_disks()
    return ref, st.device_from_reference(ref)


@pytest.fixture(scope="module")
def rings():
    ref = _two_rings()
    return ref, st.device_from_reference(ref)


@pytest.fixture(scope="module")
def grids(rings):
    ref, port = rings
    return ref_fft.build_film_grid_data(ref), port_fft.build_film_grid_data(port, "cpu")


def test_friendly_grid_size_matches():
    for n in range(2, 5001):
        assert port_fft.friendly_grid_size(n) == ref_fft.friendly_grid_size(n), n


@pytest.mark.parametrize("film", ["big_ring", "little_ring"])
def test_grid_data_matches(rings, grids, film):
    ref_grids, port_grids = grids
    a, b = ref_grids[film], port_grids[film]
    assert b.kmag.shape == a.kmag.shape
    assert (b.off_x, b.off_y) == (int(a.off_x), int(a.off_y))
    assert b.m2g_w.shape == a.m2g_w.shape
    assert _max_rel(b.kmag.numpy(), a.kmag) <= GRID_RTOL
    assert np.array_equal(b.g2m_idx.numpy(), np.asarray(a.g2m_idx))
    assert np.abs(b.g2m_w.numpy() - np.asarray(a.g2m_w)).max() <= GRID_RTOL
    # The mesh -> grid values (a grid point on a shared edge may take
    # either triangle; its value is the same).
    n = len(rings[1].meshes[film].sites)
    g = np.random.default_rng(0).standard_normal((3, n))
    ref_vals = sum(
        np.asarray(a.m2g_w)[None, :, :, k] * g[:, np.asarray(a.m2g_tri)[:, :, k]] for k in range(3)
    )
    port_vals = port_fft.grid_values(b, torch.as_tensor(g)).numpy()
    assert np.abs(port_vals - ref_vals).max() <= GRID_RTOL * np.abs(g).max()


def _trifinder_values(sites, elements, points, g):
    """``g`` interpolated at ``points`` as the JAX package's grid build does
    it: matplotlib's trifinder, then its barycentric weights (0 outside)."""
    finder = mtri.Triangulation(sites[:, 0], sites[:, 1], elements).get_trifinder()
    t = finder(points[:, 0], points[:, 1])
    out = np.zeros(len(points))
    inside = np.flatnonzero(t >= 0)
    tris = elements[t[inside]]
    p = points[inside]
    a, b, c = (sites[tris[:, k]] for k in range(3))
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    w0 = ((b[:, 0] - p[:, 0]) * (c[:, 1] - p[:, 1]) - (b[:, 1] - p[:, 1]) * (c[:, 0] - p[:, 0])) / det
    w1 = ((c[:, 0] - p[:, 0]) * (a[:, 1] - p[:, 1]) - (c[:, 1] - p[:, 1]) * (a[:, 0] - p[:, 0])) / det
    out[inside] = w0 * g[tris[:, 0]] + w1 * g[tris[:, 1]] + (1 - w0 - w1) * g[tris[:, 2]]
    return out


def test_points_on_the_outline_are_decided_as_the_trifinder_decides():
    """A square film with a square hole, triangulated on a 0.5 grid: points
    on the outer and the hole's outline (between vertices) count as inside,
    points a rounding step beyond them as outside, and the interpolated
    values agree with the trifinder's.  (At a vertex of the outline the
    trifinder's answer depends on its search tree; no such point is
    asked.)"""
    ticks = np.linspace(-2.0, 2.0, 9)
    X, Y = np.meshgrid(ticks, ticks, indexing="ij")
    sites = np.stack([X.ravel(), Y.ravel()], axis=1)
    cells = [(i, j) for i in range(8) for j in range(8) if not (2 <= i < 6 and 2 <= j < 6)]
    elements = np.array(
        [tri for i, j in cells for tri in (
            (9 * i + j, 9 * (i + 1) + j, 9 * (i + 1) + j + 1),
            (9 * i + j, 9 * (i + 1) + j + 1, 9 * i + j + 1),
        )]
    )
    outline = np.array([-2.0, -1.0, 1.0, 2.0])
    along = np.linspace(-1.875, 1.875, 16)  # never a vertex
    across = np.concatenate([outline, np.nextafter(outline, np.inf), np.nextafter(outline, -np.inf)])
    A, C = np.meshgrid(along, across, indexing="ij")
    points = np.concatenate([
        np.stack([A.ravel(), C.ravel()], axis=1),
        np.stack([C.ravel(), A.ravel()], axis=1),
        np.random.default_rng(2).uniform(-2.2, 2.2, (200, 2)),
    ])
    g = 1.0 + np.random.default_rng(1).random(len(sites))
    ref = _trifinder_values(sites, elements, points, g)
    tri = port_fft._find_triangles(sites, elements, points)
    inside = tri >= 0
    assert np.array_equal(inside, ref != 0)
    t = elements[tri[inside]]
    a, b, c = (sites[t[:, k]] for k in range(3))
    p = points[inside]
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    w0 = ((b[:, 0] - p[:, 0]) * (c[:, 1] - p[:, 1]) - (b[:, 1] - p[:, 1]) * (c[:, 0] - p[:, 0])) / det
    w1 = ((c[:, 0] - p[:, 0]) * (a[:, 1] - p[:, 1]) - (c[:, 1] - p[:, 1]) * (a[:, 0] - p[:, 0])) / det
    port = np.zeros(len(points))
    port[inside] = w0 * g[t[:, 0]] + w1 * g[t[:, 1]] + (1 - w0 - w1) * g[t[:, 2]]
    assert np.abs(port - ref).max() <= GRID_RTOL * g.max()
    # The decision was exercised on both outlines, each way.
    on_line = np.isin(points, outline).any(axis=1)
    beyond = np.isin(points, across[4:]).any(axis=1)
    assert (inside & on_line).sum() > 50 and (~inside & beyond).sum() > 50


@pytest.mark.parametrize("film", ["big_ring", "little_ring"])
def test_spectrum_and_fields_match(rings, grids, film):
    ref_grids, port_grids = grids
    n = len(rings[1].meshes[film].sites)
    g = np.random.default_rng(2).standard_normal((2, n))
    ref_spec = np.asarray(ref_fft.fft_source_spectrum(ref_grids[film], jnp.asarray(g)))
    port_spec = port_fft.fft_source_spectrum(port_grids[film], torch.as_tensor(g))
    assert _max_rel(port_spec.numpy(), ref_spec) <= SPECTRUM_RTOL
    other = "little_ring" if film == "big_ring" else "big_ring"
    stack = np.stack([ref_spec, 0.5 * ref_spec])
    ref_field = np.asarray(
        ref_fft.fft_fields_from_spectra(ref_grids[other], jnp.asarray(stack), jnp.asarray([1.0, 2.5]))
    )
    port_field = port_fft.fft_fields_from_spectra(
        port_grids[other], torch.as_tensor(stack), [1.0, 2.5]
    )
    assert _max_rel(port_field.numpy(), ref_field) <= SPECTRUM_RTOL
    single = port_fft.fft_coupling_field(port_grids[film], port_grids[other], port_spec, 1.0)
    ref_single = np.asarray(
        ref_fft.fft_coupling_field(ref_grids[film], ref_grids[other], jnp.asarray(ref_spec), 1.0)
    )
    assert _max_rel(single.numpy(), ref_single) <= SPECTRUM_RTOL


def _final_streams(solutions):
    return {name: np.asarray(fs.stream) for name, fs in solutions[-1].film_solutions.items()}


@pytest.mark.parametrize("which", ["disks", "rings"])
def test_solve_fft_matches_jax(request, which):
    ref, port = request.getfixturevalue(which)
    circ = {"big_hole": "1 mA"} if which == "rings" else None
    kw = dict(field_units="mT", current_units="uA", iterations=3, coupling="fft",
              circulating_currents=circ)
    ref_sols = sc.solve(ref, applied_field=sc.sources.ConstantField(0.5), progress_bar=False, **kw)
    port_sols = st.solve(port, applied_field=st.sources.ConstantField(0.5), torch_device="cpu", **kw)
    assert len(port_sols) == len(ref_sols) == 4
    for i in (1, 3):
        for name, a in _final_streams(ref_sols[: i + 1]).items():
            b = port_sols[i].film_solutions[name]
            assert _max_rel(b.stream, a) <= SOLVE_RTOL, (i, name)
            other = np.asarray(ref_sols[i].film_solutions[name].field_from_other_films)
            assert _max_rel(b.field_from_other_films, other) <= SOLVE_RTOL, (i, name)


@pytest.mark.parametrize("which", ["disks", "rings"])
def test_solve_many_fft_matches_jax(request, which):
    ref, port = request.getfixturevalue(which)
    fields = [0.2, 1.0, -0.5]
    kw = dict(field_units="mT", current_units="uA", iterations=3, coupling="fft")
    if which == "rings":
        kw["circulating_currents"] = [{"big_hole": 0.0}, {"big_hole": 1000.0}, {"little_hole": -300.0}]
    ref_res = ref_sweep.solve_many(
        ref, applied_fields=[sc.sources.ConstantField(v) for v in fields], **kw
    )
    port_res = st.solve_many(
        port, applied_fields=[st.sources.ConstantField(v) for v in fields], torch_device="cpu", **kw
    )
    for quantity in ("streams", "current_densities", "other_fields"):
        for name, a in getattr(ref_res, quantity).items():
            assert _max_rel(getattr(port_res, quantity)[name], a) <= SOLVE_RTOL, (quantity, name)


def test_solve_many_fft_history_matches_jax(rings):
    """Every round of an FFT sweep with ``keep_history``, against the JAX
    package's."""
    ref, port = rings
    kw = dict(field_units="mT", current_units="uA", iterations=2, coupling="fft",
              keep_history=True, circulating_currents=[{"big_hole": 500.0}, {"little_hole": 0.0}])
    ref_hist = ref_sweep.solve_many(
        ref, applied_fields=[sc.sources.ConstantField(v) for v in (0.3, -1.0)], **kw
    )
    port_hist = st.solve_many(
        port, applied_fields=[st.sources.ConstantField(v) for v in (0.3, -1.0)],
        torch_device="cpu", **kw,
    )
    assert len(port_hist) == len(ref_hist) == 3
    for i, (a, b) in enumerate(zip(ref_hist, port_hist)):
        for name, g in a.streams.items():
            assert np.all(np.isfinite(b.streams[name])), (i, name)
            assert _max_rel(b.streams[name], g) <= SOLVE_RTOL, (i, name)


@pytest.mark.parametrize("which", ["disks", "rings"])
def test_predicted_grid_is_the_built_grid(request, grids, which):
    """``coupling="auto"`` prices the grid that the FFT path then builds,
    and the JAX package predicts the same size."""
    ref, port = request.getfixturevalue(which)
    built = port_fft.build_film_grid_data(port, "cpu") if which == "disks" else grids[1]
    G = next(iter(built.values())).kmag.shape[0]
    assert port_sweep._predict_fft_grid(port) == G == ref_sweep._predict_fft_grid(ref)


def test_cost_model_prices_the_fixed_cost_of_an_fft_round(monkeypatch):
    """The FFT round's fixed cost per film keeps small films exact however
    coarse their grid, the device's work takes over on a large grid, and
    the exact pass's cost grows with its site pairs."""
    monkeypatch.setattr(port_sweep, "_FFT_MS_PER_FILM", 1.0)
    monkeypatch.setattr(port_sweep, "_FFT_DEVICE_MS_PER_GRID_UNIT", 1e-7)
    monkeypatch.setattr(port_sweep, "_EXACT_MS_PER_PAIR_SITE2", 1e-9)
    monkeypatch.setattr(port_sweep, "_EXACT_MS_PER_FILM_PAIR", 0.01)
    small = port_sweep._coupling_round_ms([10_000, 10_000], 64)
    assert small["fft"] == pytest.approx(2.0)
    assert small["exact"] == pytest.approx(2e8 * 1e-9 + 0.02)
    large = port_sweep._coupling_round_ms([10**5] * 4, 64)
    assert large["fft"] == pytest.approx(4.0) and large["exact"] > large["fft"]
    huge_grid = port_sweep._coupling_round_ms([10**5] * 4, 4096)
    assert huge_grid["fft"] == pytest.approx(4 * 1e-7 * 4096**2 * 12)


def test_fft_departs_from_exact_as_in_the_reference(rings):
    """The FFT transfer is an approximation: on rings with a circulating
    current the port's FFT and exact sweeps differ as the JAX package's do,
    because the grid leaves the holes empty."""
    ref, port = rings
    kw = dict(field_units="mT", current_units="uA", iterations=3,
              circulating_currents=[{"little_hole": 1000.0}])
    gaps = {}
    for coupling in ("fft", "exact"):
        gaps[coupling] = st.solve_many(
            port, applied_fields=[st.sources.ConstantField(0)], torch_device="cpu",
            coupling=coupling, **kw,
        ).streams
    ref_gaps = {
        coupling: ref_sweep.solve_many(
            ref, applied_fields=[sc.sources.ConstantField(0)], coupling=coupling, **kw
        ).streams
        for coupling in ("fft", "exact")
    }
    for name in gaps["fft"]:
        port_gap = _max_rel(gaps["fft"][name], gaps["exact"][name])
        ref_gap = _max_rel(ref_gaps["fft"][name], ref_gaps["exact"][name])
        assert port_gap > 1e-5
        assert port_gap == pytest.approx(ref_gap, rel=1e-5), name


def _models(ref, port):
    return (
        sc.factorize_model(device=ref, current_units="uA"),
        st.factorize_model(device=port, current_units="uA", torch_device="cpu"),
    )


@pytest.mark.parametrize("which", ["disks", "rings"])
def test_auto_is_exact_on_small_meshes(request, which):
    ref, port = request.getfixturevalue(which)
    ref_model, port_model = _models(ref, port)
    films = list(port.films)
    for iterations in (0, 3):
        assert port_sweep._resolve_auto_coupling(port_model, films, iterations) == "exact"
        assert ref_sweep._resolve_auto_coupling(ref_model, films, iterations) == "exact"
    kw = dict(field_units="mT", current_units="uA", iterations=2, torch_device="cpu")
    auto = st.solve(port, applied_field=st.sources.ConstantField(1.0), coupling="auto", **kw)
    exact = st.solve(port, applied_field=st.sources.ConstantField(1.0), coupling="exact", **kw)
    for name in port.films:
        assert np.array_equal(auto[-1].film_solutions[name].stream,
                              exact[-1].film_solutions[name].stream)
    assert port_model.fft_grids is None


@pytest.mark.parametrize("min_n", [1, 10**6])
def test_min_n_override_picks_the_same_mode(rings, monkeypatch, min_n):
    monkeypatch.setenv("SUPERSCREEN_TPU_FFT_COUPLING_MIN_N", str(min_n))
    ref_model, port_model = _models(*rings)
    films = list(rings[1].films)
    expected = "fft" if min_n == 1 else "exact"
    assert port_sweep._resolve_auto_coupling(port_model, films, 2) == expected
    assert ref_sweep._resolve_auto_coupling(ref_model, films, 2) == expected
    # One film or no rounds: exact whatever the threshold.
    assert port_sweep._resolve_auto_coupling(port_model, films[:1], 2) == "exact"
    assert port_sweep._resolve_auto_coupling(port_model, films, 0) == "exact"


def test_auto_under_the_override_runs_the_fft_rounds(rings, monkeypatch):
    ref, port = rings
    monkeypatch.setenv("SUPERSCREEN_TPU_FFT_COUPLING_MIN_N", "1")
    kw = dict(field_units="mT", current_units="uA", iterations=2)
    ref_res = ref_sweep.solve_many(ref, applied_fields=[sc.sources.ConstantField(1.0)], **kw)
    port_res = st.solve_many(
        port, applied_fields=[st.sources.ConstantField(1.0)], torch_device="cpu", **kw
    )
    fft = st.solve_many(
        port, applied_fields=[st.sources.ConstantField(1.0)], torch_device="cpu",
        coupling="fft", **kw,
    )
    for name, a in ref_res.streams.items():
        assert _max_rel(port_res.streams[name], a) <= SOLVE_RTOL
        assert np.array_equal(port_res.streams[name], fft.streams[name])


def test_grids_are_cached_on_the_model(rings):
    port = rings[1]
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    kw = dict(applied_fields=[st.sources.ConstantField(1.0)], iterations=1, coupling="fft",
              torch_device="cpu")
    st.solve_many(model=model, **kw)
    grids = model.fft_grids
    assert set(grids) == set(port.films)
    st.solve_many(model=model, **kw)
    assert model.fft_grids is grids


def test_coincident_heights_raise():
    layers = [sc.Layer("a", Lambda=1.0, z0=0.5), sc.Layer("b", Lambda=1.0, z0=0.5)]
    films = [
        sc.Polygon("left", layer="a", points=geo.circle(1.0, points=30, center=(-2, 0))),
        sc.Polygon("right", layer="b", points=geo.circle(1.0, points=30, center=(2, 0))),
    ]
    ref = sc.Device("flat", layers=layers, films=films, solve_dtype="float64")
    ref.make_mesh(max_edge_length=0.4)
    port = st.device_from_reference(ref)
    kw = dict(iterations=2, coupling="fft", torch_device="cpu")
    with pytest.raises(ValueError, match="distinct layer heights"):
        st.solve_many(port, applied_fields=[st.sources.ConstantField(1.0)], **kw)
    with pytest.raises(ValueError, match="distinct layer heights"):
        st.solve(port, applied_field=st.sources.ConstantField(1.0), **kw)
    with pytest.raises(ValueError, match="distinct layer heights"):
        ref_sweep.solve_many(ref, applied_fields=[sc.sources.ConstantField(1.0)], iterations=2,
                             coupling="fft")
    # "auto" stays exact there, under the override too.
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    assert port_sweep._resolve_auto_coupling(model, list(port.films), 2) == "exact"
    with pytest.raises(ValueError, match="'auto', 'exact', or 'fft'"):
        st.solve_many(model=model, applied_fields=[st.sources.ConstantField(1.0)],
                      coupling="fast", torch_device="cpu")
    with pytest.raises(ValueError, match="'auto', 'exact', or 'fft'"):
        st.solve(model=model, coupling="fast", torch_device="cpu")


def test_high_precision_forces_exact(disks):
    port = disks[1]
    kw = dict(applied_field=st.sources.ConstantField(1.0), iterations=2, torch_device="cpu",
              high_precision=True)
    fft = st.solve(port, coupling="fft", **kw)
    exact = st.solve(port, coupling="exact", **kw)
    for name in port.films:
        assert np.array_equal(fft[-1].film_solutions[name].stream,
                              exact[-1].film_solutions[name].stream)


def test_edge_mesh_and_mesh_stats(rings):
    ref, port = rings
    for name, mesh in port.meshes.items():
        ref_mesh = ref.meshes[name]
        ref_edges, port_edges = ref_mesh.edge_mesh, mesh.edge_mesh
        for field in ("centers", "edges", "boundary_edge_indices", "directions", "edge_lengths"):
            assert np.array_equal(getattr(port_edges, field), getattr(ref_edges, field)), field
        ref_stats, port_stats = ref_mesh.stats(), mesh.stats()
        assert port_stats.keys() == ref_stats.keys()
        for key, value in ref_stats.items():
            assert port_stats[key] == pytest.approx(value, rel=1e-14), key
        copy = port_edges.copy()
        assert copy.edges is not port_edges.edges and np.array_equal(copy.edges, port_edges.edges)
        assert np.array_equal(mesh.copy().edge_mesh.edge_lengths, port_edges.edge_lengths)

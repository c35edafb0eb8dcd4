"""The port's plots and visualization helpers against the JAX package's,
with matplotlib's Agg backend on the CPU.

The JAX package solves the device of ``tests/test_visualization.py``; the
port's Solutions hold the same arrays on the same meshes (through
``device_from_reference``), so that every plot function and method draws
the same figure from the same data: the same number of axes, and the
arrays behind each colour map, line and contour equal at 1e-12.  The
NumPy helpers are held to the JAX package's at 1e-12 too."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import superscreen_tpu as sc  # noqa: E402
import superscreen_tpu.geometry as geo  # noqa: E402
import superscreen_tpu_torch as st  # noqa: E402
from superscreen_tpu import visualization as ref_vis  # noqa: E402
from superscreen_tpu_torch import visualization as vis  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-12


@pytest.fixture(scope="module")
def solutions():
    layers = [sc.Layer("layer0", Lambda=1, z0=0), sc.Layer("layer1", Lambda=2, z0=0.5)]
    films = [
        sc.Polygon("disk", layer="layer0", points=geo.circle(4, points=50)),
        sc.Polygon("ring", layer="layer1", points=geo.circle(3, points=50)),
    ]
    holes = [sc.Polygon("hole", layer="layer1", points=geo.circle(1.2, points=30))]
    device = sc.Device("device", layers=layers, films=films, holes=holes, solve_dtype="float64")
    device.make_mesh(min_points=300)
    ref = sc.solve(
        device=device, applied_field=sc.sources.ConstantField(0.5),
        circulating_currents={"hole": "50 uA"}, field_units="mT", current_units="uA",
        iterations=1, progress_bar=False,
    )
    port_device = st.device_from_reference(device)
    port = []
    for solution in ref:
        solution.device.solve_dtype = device.solve_dtype
        port.append(st.Solution(
            device=port_device,
            film_solutions={
                name: st.FilmSolution(
                    stream=fs.stream, current_density=fs.current_density,
                    applied_field=fs.applied_field, self_field=fs.self_field,
                    field_from_other_films=fs.field_from_other_films,
                )
                for name, fs in solution.film_solutions.items()
            },
            applied_field_func=st.sources.ConstantField(0.5),
            field_units="mT", current_units="uA",
            circulating_currents=solution.circulating_currents,
            torch_device="cpu",
        ))
    return ref, port


def _drawn(fig):
    """The arrays a figure shows: colour-mapped arrays, line data, and the
    offsets of point collections, axis by axis."""
    out = []
    for ax in fig.axes:
        for artist in ax.collections:
            array = artist.get_array()
            if array is not None:
                out.append(np.asarray(array, dtype=float))
        for line in ax.get_lines():
            out.append(np.asarray(line.get_xydata(), dtype=float))
    return out


def _assert_same_figures(port_figs, ref_figs):
    assert len(port_figs) == len(ref_figs)
    for a, b in zip(port_figs, ref_figs):
        assert len(a.axes) == len(b.axes)
        got, want = _drawn(a), _drawn(b)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.shape == y.shape
            finite = np.isfinite(y)
            np.testing.assert_array_equal(finite, np.isfinite(x))
            if finite.any():
                scale = max(np.abs(y[finite]).max(), 1.0)
                assert np.abs(x[finite] - y[finite]).max() <= TOL * scale


def _grid(n=20, half=4.0):
    xs = np.linspace(-half, half, n)
    X, Y = np.meshgrid(xs, xs)
    return np.stack([X.ravel(), Y.ravel()], axis=1)


CUT = np.stack([np.linspace(-2, 2, 30), np.zeros(30)], axis=1)

PLOTS = {
    "streams_flat": lambda m, s: m.plot_streams(s[-1], shading="flat"),
    "streams_gouraud": lambda m, s: m.plot_streams(s[-1], shading="gouraud"),
    "streams_layer": lambda m, s: m.plot_streams_layer(s[-1], "ring")[0].get_figure(),
    "fields_field": lambda m, s: m.plot_fields(s[-1], dataset="field", auto_range_cutoff=1),
    "fields_self": lambda m, s: m.plot_fields(s[-1], dataset="self_field"),
    "fields_applied": lambda m, s: m.plot_fields(s[-1], dataset="applied_field"),
    "fields_other": lambda m, s: m.plot_fields(s[-1], dataset="field_from_other_films"),
    "fields_options": lambda m, s: m.plot_fields(
        s[-1], films=["disk"], normalize=True, share_color_scale=True,
        symmetric_color_scale=True, cross_section_coords=CUT,
    ),
    "currents": lambda m, s: m.plot_currents(s[-1], streamplot=False, units="mA/um"),
    "currents_streamplot": lambda m, s: m.plot_currents(s[-1], streamplot=True),
    "field_at_positions": lambda m, s: m.plot_field_at_positions(
        s[-1], _grid(), zs=1.5, cross_section_coords=CUT
    ),
    "polygon_flux": lambda m, s: m.plot_polygon_flux(s),
    "polygon_flux_diff": lambda m, s: m.plot_polygon_flux(s, diff=True, logy=True),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plot_functions_draw_what_the_reference_draws(solutions, name):
    ref, port = solutions
    with vis.non_gui_backend():
        got = PLOTS[name](vis, port)
        want = PLOTS[name](ref_vis, ref)
        figs = [f[0] if isinstance(f, tuple) else f for f in (got, want)]
        _assert_same_figures([figs[0]], [figs[1]])
        plt.close("all")


@pytest.mark.parametrize("diff, kwargs", [(False, {}), (True, {"logy": True}),
                                          (True, {"absolute": True})])
def test_plot_mutual_inductance(diff, kwargs):
    base = np.array([[10.0, -2.0], [-2.0, 8.0]])
    Ms = [base * (1 + 0.1 * 0.5**k) for k in range(4)]
    with vis.non_gui_backend():
        got = vis.plot_mutual_inductance(Ms, diff=diff, **kwargs)[0]
        want = ref_vis.plot_mutual_inductance(Ms, diff=diff, **kwargs)[0]
        _assert_same_figures([got], [want])
        plt.close("all")


METHODS = {
    "solution_aliases": lambda s, d: [
        s.plot_streams()[0], s.plot_fields()[0], s.plot_currents()[0],
        s.plot_field_at_positions(_grid(12), zs=2.0)[0],
    ],
    "plot_polygons": lambda s, d: [d.plot_polygons(legend=True)[0]],
    "plot_polygons_subplots": lambda s, d: [d.plot_polygons(subplots=True)[0]],
    "plot_mesh": lambda s, d: [d.plot_mesh(show_sites=True)[0]],
    "plot_mesh_subplots": lambda s, d: [d.plot_mesh(subplots=True)[0]],
    "draw": lambda s, d: [d.draw()[0]],
    "draw_subplots": lambda s, d: [d.draw(subplots=True, legend=True, exclude="ring")[0]],
    "mesh_plot": lambda s, d: [d.meshes["disk"].plot(show_sites=True).get_figure()],
    "polygon_plot": lambda s, d: [d.films["ring"].plot().get_figure()],
}


@pytest.mark.parametrize("name", list(METHODS))
def test_plot_methods_draw_what_the_reference_draws(solutions, name):
    ref, port = solutions
    with vis.non_gui_backend():
        got = METHODS[name](port[-1], port[-1].device)
        want = METHODS[name](ref[-1], ref[-1].device)
        _assert_same_figures(got, want)
        plt.close("all")


def test_device_patches_match(solutions):
    ref, port = solutions
    got, want = port[-1].device.patches(), ref[-1].device.patches()
    assert {k: list(v) for k, v in got.items()} == {k: list(v) for k, v in want.items()}
    for layer, patches in want.items():
        for name, patch in patches.items():
            np.testing.assert_array_equal(
                got[layer][name].get_path().vertices, patch.get_path().vertices
            )
    assert port[-1].device.meshes["disk"].triangulation.triangles.shape == (
        ref[-1].device.meshes["disk"].triangulation.triangles.shape
    )


@pytest.mark.parametrize("cutoff", [1, (2, 5), 0])
def test_auto_range_iqr_matches(cutoff):
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(size=1000), [1000.0, -50.0]])
    np.testing.assert_allclose(
        vis.auto_range_iqr(data, cutoff), ref_vis.auto_range_iqr(data, cutoff), rtol=TOL
    )


def test_grids_to_vecs_and_make_lims_match():
    xg, yg = np.meshgrid(np.arange(3.0), np.arange(4.0))
    for got, want in zip(vis.grids_to_vecs(xg, yg), ref_vis.grids_to_vecs(xg, yg)):
        np.testing.assert_array_equal(got, want)
    vals = np.random.default_rng(1).normal(size=50)
    np.testing.assert_allclose(vis.make_lims(vals, 0.1), ref_vis.make_lims(vals, 0.1), rtol=TOL)


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("cutoff", [None, 1])
def test_setup_color_limits_matches(share, symmetric, cutoff):
    rng = np.random.default_rng(2)
    arrays = {"a": rng.normal(size=100), "b": 3 + rng.normal(size=80)}
    kwargs = dict(share_color_scale=share, symmetric_color_scale=symmetric,
                  auto_range_cutoff=cutoff)
    got = vis.setup_color_limits(arrays, **kwargs)
    want = ref_vis.setup_color_limits(arrays, **kwargs)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_cross_section_matches(solutions, method):
    ref, port = solutions
    mesh = port[-1].device.meshes["disk"]
    values = port[-1].film_solutions["disk"].total_field
    cuts = [CUT, CUT[::-1] + [0.5, 1.0]]
    got = vis.cross_section(mesh.sites, values, cuts, interp_method=method)
    want = ref_vis.cross_section(mesh.sites, values, cuts, interp_method=method)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL * np.abs(values).max())


def test_auto_grid_matches():
    with vis.non_gui_backend():
        for n, cols in ((5, 2), (1, 3), (4, 4)):
            fig, axes = vis.auto_grid(n, max_cols=cols)
            ref_fig, ref_axes = ref_vis.auto_grid(n, max_cols=cols)
            assert len(fig.axes) == len(ref_fig.axes) == n
            assert np.shape(axes) == np.shape(ref_axes)
        plt.close("all")

"""The port's device transforms and polygon queries against the JAX
package's: ``scale``, ``rotate``, ``mirror_layers``, ``translate`` and
``translation`` (polygons and layer heights at 1e-15), a translated
device's float64 solve against the untranslated one (1e-10) and its
interpolation at translated points (1e-12, so that no triangle index of
the old positions survives), ``on_boundary`` and ``contains_points(radius=)``
decided point for point as matplotlib decides them, the polygon folds,
``poly_points`` and the mesh statistics; and that a polygon's ring is
checked for simplicity once, not again by copies of it or of its device,
unless it was edited in place."""

import copy
import pickle

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu_torch import io as st_io
from superscreen_tpu_torch import tracing

torch.set_num_threads(2)

POLY_TOL = 1e-15
STREAM_TOL = 1e-10
INTERP_TOL = 1e-12


def _device(pkg, mesh=True):
    layers = [pkg.Layer("base", Lambda=1.0, z0=0.0), pkg.Layer("top", Lambda=0.5, z0=1.0)]
    films = [
        pkg.Polygon("ring", layer="base", points=geo.circle(5, points=60)),
        pkg.Polygon("disk", layer="top", points=geo.circle(3, points=40)),
    ]
    holes = [pkg.Polygon("hole", layer="base", points=geo.circle(2, points=30))]
    abstract = [pkg.Polygon("patch", layer="top", points=geo.box(1.0, center=(1.0, 0.5)))]
    device = pkg.Device(
        "stack", layers=layers, films=films, holes=holes, abstract_regions=abstract,
        solve_dtype="float64",
    )
    if mesh:
        device.make_mesh(max_edge_length=0.9)
    return device


def _assert_same_geometry(port, ref):
    assert list(port.layers) == list(ref.layers)
    for name, layer in ref.layers.items():
        assert abs(port.layers[name].z0 - layer.z0) <= POLY_TOL
    ref_polys = {p.name: p for p in ref.get_polygons()}
    for polygon in port.get_polygons():
        want = ref_polys[polygon.name].points
        assert polygon.points.shape == want.shape
        np.testing.assert_allclose(polygon.points, want, rtol=0, atol=POLY_TOL * np.abs(want).max())


TRANSFORMS = {
    "scale": lambda d: d.scale(xfact=1.5, yfact=-0.5, origin=(0.3, -0.2)),
    "rotate": lambda d: d.rotate(37.0, origin=(1.0, 2.0)),
    "mirror_layers": lambda d: d.mirror_layers(about_z=0.25),
    "translate": lambda d: d.translate(dx=3.0, dy=-2.0, dz=0.5),
    "translate_inplace": lambda d: d.translate(dx=-1.0, dy=4.0, inplace=True),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_match_reference(name, caplog):
    port, ref = _device(st), _device(sc)
    out_port, out_ref = TRANSFORMS[name](port), TRANSFORMS[name](ref)
    _assert_same_geometry(out_port, out_ref)
    keeps_mesh = name.startswith("translate")
    assert (out_port.meshes is not None) == keeps_mesh == (out_ref.meshes is not None)
    if keeps_mesh:
        assert (out_port is port) == name.endswith("inplace")
        shift = np.array([3.0, -2.0]) if name == "translate" else np.array([-1.0, 4.0])
        for film in port.films:
            base = _device(st).meshes[film]
            mesh = out_port.meshes[film]
            # Sites on an outline may move by a few ulps (Device.translate).
            np.testing.assert_allclose(mesh.sites, base.sites + shift, rtol=0, atol=1e-13)
            np.testing.assert_array_equal(mesh.operators.sites, mesh.sites)
            np.testing.assert_allclose(mesh.triangle_centroids, base.triangle_centroids + shift,
                                       atol=1e-14)
            np.testing.assert_allclose(mesh.edge_mesh.centers, base.edge_mesh.centers + shift,
                                       atol=1e-14)
    else:
        assert "returns a new device with no mesh" in caplog.text


def test_transform_arguments_are_checked():
    port = _device(st, mesh=False)
    for call in (lambda: port.rotate(10, origin=[0, 0]), lambda: port.scale(origin="center")):
        with pytest.raises(TypeError, match="Origin must be a tuple"):
            call()


def _solve(device):
    return st.solve(
        device, applied_field=st.sources.ConstantField(0.3), circulating_currents={"hole": "2 uA"},
        iterations=2, coupling="exact", torch_device="cpu", progress_bar=False,
    )[-1]


POINTS = np.random.default_rng(3).uniform(-2.5, 2.5, (200, 2))
SHIFT = np.array([2.5, -1.5])


def _interpolate(solution, points, what, method):
    out = {}
    for film in ("ring", "disk"):
        if what == "field":
            out[film] = solution.interp_field(points, film=film, method=method)
        else:
            out[film] = solution.interp_current_density(points, film=film, method=method)
    return out


@pytest.fixture(scope="module")
def solved():
    """A device solved, interpolated (which builds its meshes' triangle
    indices), translated in place and solved again: the second solution
    interpolates on the same mesh objects at their new positions."""
    device = _device(st)
    original = _solve(device)
    before = {
        (what, method): _interpolate(original, POINTS, what, method)
        for what in ("field", "current_density")
        for method in ("linear", "cubic")
    }
    device.translate(dx=SHIFT[0], dy=SHIFT[1], inplace=True)
    return original, before, _solve(device)


def test_translated_solve_matches(solved):
    original, _, moved = solved
    for name, fs in original.film_solutions.items():
        other = moved.film_solutions[name]
        for key in ("stream", "current_density", "self_field", "field_from_other_films"):
            want, got = getattr(fs, key), getattr(other, key)
            assert np.abs(got - want).max() <= STREAM_TOL * np.abs(want).max(), (name, key)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("what", ["field", "current_density"])
def test_translated_solution_interpolates_at_translated_points(solved, method, what):
    _, before, moved = solved
    after = _interpolate(moved, POINTS + SHIFT, what, method)
    for film, want in before[(what, method)].items():
        got = after[film]
        finite = np.isfinite(want)
        assert finite.sum() > 50
        assert np.array_equal(finite, np.isfinite(got))
        scale = np.abs(want[finite]).max()
        assert np.abs(got[finite] - want[finite]).max() <= INTERP_TOL * scale


def _two_rings(pkg, solve_dtype):
    """Two stacked rings meshed so that sites lie on the hole outlines:
    translated with their outlines, some round to the other side."""
    layers = [pkg.Layer("l0", Lambda=1.0, z0=0), pkg.Layer("l1", Lambda=0.5, z0=1)]
    films = [
        pkg.Polygon("big", layer="l0", points=geo.circle(7.5, points=120)),
        pkg.Polygon("small", layer="l1", points=geo.circle(5, points=100)),
    ]
    holes = [
        pkg.Polygon("big_hole", layer="l0", points=geo.circle(3.75, points=70)),
        pkg.Polygon("small_hole", layer="l1", points=geo.circle(2.5, points=60)),
    ]
    device = pkg.Device("two", layers=layers, films=films, holes=holes, solve_dtype=solve_dtype)
    device.make_mesh(min_points=900)
    return device


@pytest.mark.parametrize("solve_dtype, tol", [("float64", STREAM_TOL), ("float32", 1e-4)])
@pytest.mark.parametrize("shift", [(3.0, -2.0), (50.0, 50.0)])
def test_translation_keeps_every_site_on_its_side(solve_dtype, tol, shift, capsys):
    """A translated copy keeps every site on its side of every outline, so
    its index sets and its streams are the original's (1e-4 in float32,
    the bar of ``chip_smoke.py`` phase 15).  The JAX package's
    ``translate`` lets sites on the hole outlines change sides; its
    distance is printed beside the port's."""
    kwargs = dict(applied_field=None, circulating_currents={"big_hole": "2 uA"}, iterations=3)
    errors = {}
    for name, pkg in (("port", st), ("jax", sc)):
        device = _two_rings(pkg, solve_dtype)
        moved = device.translate(*shift)
        extra = dict(torch_device="cpu", coupling="exact") if pkg is st else {}
        kw = dict(kwargs, applied_field=pkg.sources.ConstantField(0.5), progress_bar=False, **extra)
        ref, out = pkg.solve(device, **kw)[-1], pkg.solve(moved, **kw)[-1]
        errors[name] = max(
            float(np.abs(out.film_solutions[k].stream - fs.stream).max() / np.abs(fs.stream).max())
            for k, fs in ref.film_solutions.items()
        )
        if pkg is st:
            for film in device.films:
                for a, b in zip(device._sides(film), moved._sides(film)):
                    np.testing.assert_array_equal(a, b)
    with capsys.disabled():
        print(f"\ntranslate{shift} {solve_dtype}: stream distance port {errors['port']:.3e}, "
              f"JAX package {errors['jax']:.3e}")
    assert errors["port"] <= tol


@pytest.mark.parametrize("reach", [0, 16])
def test_a_site_that_cannot_be_put_back_raises(reach):
    """Shifted by (3, -2), some sites on the hole outlines round to the
    other side.  Within 16 ulps each finds a point back on its side; with
    no room to search (``reach=0``) the translation raises instead of
    changing the film's index sets."""
    from superscreen_tpu_torch.device.device import _restore_sides

    device = _two_rings(st, "float64")
    shift = (3.0, -2.0)
    sides = {film: device._sides(film) for film in device.films}
    for polygon in device.get_polygons():
        polygon.translate(*shift, inplace=True)
    flipped = 0
    for film, mesh in device.meshes.items():
        mesh.translate_sites(*shift)
        flipped += sum(int(np.sum(a != b)) for a, b in zip(sides[film], device._sides(film)))
    assert flipped > 0
    for film, mesh in device.meshes.items():
        polygons = device._layer_polygons(film)
        if reach == 0 and any(np.any(a != b) for a, b in zip(sides[film], device._sides(film))):
            with pytest.raises(RuntimeError, match=r"changed sides of .* by \(3.0, -2.0\)"):
                _restore_sides(mesh, polygons, sides[film], shift, reach=reach)
        else:
            _restore_sides(mesh, polygons, sides[film], shift, reach=reach)
            for a, b in zip(sides[film], device._sides(film)):
                np.testing.assert_array_equal(a, b)


def test_translation_context_restores():
    device = _device(st)
    sites = {name: mesh.sites.copy() for name, mesh in device.meshes.items()}
    points = [p.points.copy() for p in device.get_polygons()]
    with device.translation(1.0, -2.0, dz=0.5):
        assert device.layers["top"].z0 == 1.5
        np.testing.assert_array_equal(device.meshes["disk"].sites, sites["disk"] + [1.0, -2.0])
    assert device.layers["top"].z0 == 1.0
    for name, mesh in device.meshes.items():
        np.testing.assert_allclose(mesh.sites, sites[name], atol=1e-14)
    for polygon, before in zip(device.get_polygons(), points):
        np.testing.assert_allclose(polygon.points, before, atol=1e-14)


SHAPES = {
    "circle": geo.circle(3, points=40),
    "box": geo.box(4, 2),
    "ell": np.array([[0, 0], [4, 0], [4, 1], [1, 1], [1, 3], [0, 3]], float),
    "sliver": np.array([[0, 0], [4, 0], [0, 0.5]], float),
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("radius", [1e-3, 0.1, 0.3, -0.3, 1.0])
def test_point_queries_with_a_radius_match_matplotlib(shape, radius):
    """``contains_points(radius=)`` and ``on_boundary`` decide every point
    as the JAX package's matplotlib paths do: random points, points on the
    outline, near it and the vertices."""
    ref = sc.Polygon("p", layer="l", points=SHAPES[shape])
    port = st.Polygon("p", layer="l", points=SHAPES[shape])
    rng = np.random.default_rng(7)
    ring = ref.points
    t = rng.uniform(size=(1000, 1))
    i = rng.integers(0, len(ring) - 1, 1000)
    on = ring[i] * (1 - t) + ring[i + 1] * t
    points = np.concatenate([
        rng.uniform(-5, 5, (20000, 2)), on, on + rng.normal(scale=0.05, size=on.shape), ring,
    ])
    np.testing.assert_array_equal(
        port.contains_points(points, radius=radius), ref.contains_points(points, radius=radius)
    )
    if radius > 0:
        np.testing.assert_array_equal(
            port.on_boundary(points, radius=radius), ref.on_boundary(points, radius=radius)
        )
        np.testing.assert_array_equal(
            port.on_boundary(points, radius=radius, index=True),
            ref.on_boundary(points, radius=radius, index=True),
        )


def test_polygon_conveniences_match_reference():
    a = [geo.box(4, 2), geo.circle(1.5, center=(1, 0.5), points=50), geo.box(1, 3, center=(-1, 0))]
    for method, kwargs in (
        ("from_union", {}), ("from_intersection", {}), ("from_difference", {}),
    ):
        ref = getattr(sc.Polygon, method)(a[:2], name="x", layer="l", **kwargs)
        port = getattr(st.Polygon, method)(a[:2], name="x", layer="l", **kwargs)
        assert (port.name, port.layer) == (ref.name, ref.layer)
        np.testing.assert_allclose(port.points, ref.points, atol=POLY_TOL * 4)
    port = st.Polygon("p", layer="l", points=a[0])
    assert port.set_name("q") is port and port.name == "q"
    assert port.polygon is port.points
    ref_path = sc.Polygon("p", layer="l", points=a[0]).path
    np.testing.assert_array_equal(port.path.vertices, ref_path.vertices)


def test_device_poly_points_and_mesh_stats_match_reference():
    port, ref = _device(st), st.device_from_reference(_device(sc))
    ref_jax = _device(sc)
    np.testing.assert_array_equal(port.poly_points, ref_jax.poly_points)
    assert port.length_units == ref_jax.length_units == "um"
    with pytest.raises(AttributeError):
        port.length_units = "nm"
    stats = ref.mesh_stats_dict()
    want = ref_jax.mesh_stats_dict()
    assert stats.keys() == want.keys()
    for name in want:
        assert stats[name].keys() == want[name].keys()
        for key, value in want[name].items():
            assert stats[name][key] == pytest.approx(value, rel=1e-15)
    html = ref.mesh_stats()
    assert "Mesh Statistics" in str(getattr(html, "data", html))
    assert st.Device("empty", layers=port.layers, films=port.films).mesh_stats_dict() is None


def test_polygons_by_layer_accepts_all():
    port, ref = _device(st, mesh=False), _device(sc, mesh=False)
    for kind in (None, "all", "film", "hole", "abstract", "terminal"):
        got = {k: [p.name for p in v] for k, v in port.polygons_by_layer(kind).items()}
        want = {k: [p.name for p in v] for k, v in ref.polygons_by_layer(kind).items()}
        assert got == want
    with pytest.raises(ValueError, match="Invalid polygon type"):
        port.polygons_by_layer("nope")


BOX = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], float)


def _counted(fn):
    """``fn()`` and the simplicity checks of polygon rings it ran
    (``tracing.POLYGON_CHECKS``, recorded under a profile)."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    checks = tracing.snapshot()["counters"].get(tracing.POLYGON_CHECKS, 0)
    tracing.reset()
    return out, checks


def _bowtie(polygon):
    """Swaps two vertices of ``polygon``'s ring in place: its edges cross."""
    ring = polygon.points
    ring[[1, 2]] = ring[[2, 1]]


def test_a_device_and_its_copies_check_each_ring_once():
    """Building a device checks each ring once, as it is set; copies of the
    device, copies of the copies and ``is_valid`` check none again."""
    device, checks = _counted(lambda: _device(st, mesh=False))
    assert checks == len(device.get_polygons()) == 4
    copies, checks = _counted(lambda: [device.copy(), device.copy().copy(), device.copy(with_mesh=False)])
    assert checks == 0
    for clone in copies:
        assert clone == device and clone is not device
        assert all(a is not b for a, b in zip(clone.get_polygons(), device.get_polygons()))
    valid, checks = _counted(lambda: [p.is_valid for p in device.get_polygons()])
    assert valid == [True] * 4 and checks == 0


def test_a_ring_edited_in_place_is_checked_again():
    """An edit in place that keeps the ring simple is checked once and
    accepted; one that makes a bowtie fails ``is_valid`` on every call, and
    the device, a copy of it, or a new device with it raise as they do for a
    bowtie given to the constructor."""
    layers = [st.Layer("base", Lambda=1.0, z0=0.0)]
    film = st.Polygon("film", layer="base", points=BOX)
    device = st.Device("d", layers=layers, films=[film])
    ring = film.points
    ring *= 2.0
    valid, checks = _counted(lambda: (film.is_valid, film.is_valid))
    assert valid == (True, True) and checks == 1
    clone, checks = _counted(device.copy)
    assert checks == 0 and clone.films["film"].points.max() == 4.0
    _bowtie(film)
    valid, checks = _counted(lambda: (film.is_valid, film.is_valid))
    assert valid == (False, False) and checks == 2
    with pytest.raises(ValueError, match="film is not valid"):
        device.copy()
    with pytest.raises(ValueError, match="film is not valid"):
        st.Device("again", layers=layers, films=[film])
    with pytest.raises(ValueError, match="valid simply-connected"):
        st.Polygon("film", layer="base", points=film.points)


def _through_hdf5(polygon, tmp_path):
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "p.h5", "w") as f:
        polygon.to_hdf5(f.create_group("p"))
    with h5py.File(tmp_path / "p.h5", "r") as f:
        return st.Polygon.from_hdf5(f["p"])


def _through_io(polygon, tmp_path):
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "p.h5", "w") as f:
        st_io.serialize_obj(f, polygon, "p")
    with h5py.File(tmp_path / "p.h5", "r") as f:
        return st_io.deserialize_obj(f, "p")


def _without_verdict(polygon, tmp_path):
    """The polygon as a pickle of it made without the verdict's slot
    unpickles: name, layer and ring alone."""
    clone = object.__new__(st.Polygon)
    for slot in ("name", "layer", "_points"):
        setattr(clone, slot, copy.deepcopy(getattr(polygon, slot)))
    return clone


ROUTES = {
    "copy": lambda p, _: p.copy(),
    "deepcopy": lambda p, _: copy.deepcopy(p),
    "pickle": lambda p, _: pickle.loads(pickle.dumps(p)),
    "io": _through_io,
    "hdf5": _through_hdf5,
    "without_verdict": _without_verdict,
}


def _shifted():
    polygon = st.Polygon("p", layer="l", points=BOX)
    ring = polygon.points
    ring += 1.0
    return polygon


def _bowtied():
    polygon = st.Polygon("p", layer="l", points=BOX)
    _bowtie(polygon)
    return polygon


STATES = {
    "valid": lambda: st.Polygon("p", layer="l", points=BOX),
    "unnamed": lambda: st.Polygon(layer="l", points=BOX),
    "edited": _shifted,
    "bowtie": _bowtied,
}


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_copied_pickled_and_read_polygons_keep_is_valid(tmp_path, route, state):
    """A copied, pickled or read-back polygon gives its source's
    ``is_valid`` (a bowtie cannot be written to HDF5 and read back: the
    reader checks the ring as the constructor does); a copy or pickle of a
    ring that passed carries the verdict and checks nothing again."""
    source = STATES[state]()
    want = source.is_valid
    if route == "hdf5" and state == "bowtie":
        with pytest.raises(ValueError, match="valid simply-connected"):
            ROUTES[route](source, tmp_path)
        return
    clone = ROUTES[route](source, tmp_path)
    assert type(clone) is st.Polygon and clone == source
    valid, checks = _counted(lambda: clone.is_valid)
    assert valid == want
    if want and route in ("copy", "deepcopy", "pickle", "io"):
        assert checks == 0

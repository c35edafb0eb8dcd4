"""Every post-processing method of the port's ``Solution`` against the
``superscreen_tpu`` ``Solution`` of the same device, mesh and drive (through
``device_from_reference``), after one coupled solve in each package, at
float64 on the CPU.

The reference's ``Solution`` copies its device without the solve dtype, so
its post-processing always runs at the default float32 whatever the device
was solved at; the port's copy carries the dtype.  The float64 fixtures set
the reference copy's dtype to the device's, so that both sides hold their
results in float64."""

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st

torch.set_num_threads(2)

# The tolerance of the streams the methods read (float64 on both sides; LU
# pivoting and summation orders differ), relative to max|reference|.
RTOL = 1e-8
CIRC = {"hole": "2 uA"}


def _two_films(solve_dtype="float64", z_top=1.0):
    """A ring with a hole under a disk: two films in two layers."""
    layers = [sc.Layer("base", Lambda=1.0, z0=0), sc.Layer("top", Lambda=0.5, z0=z_top)]
    films = [
        sc.Polygon("ring", layer="base", points=geo.circle(5, points=60)),
        sc.Polygon("disk", layer="top", points=geo.circle(3, points=40)),
    ]
    holes = [sc.Polygon("hole", layer="base", points=geo.circle(2, points=30))]
    abstract = [sc.Polygon("patch", layer="base", points=geo.box(1.0, center=(3.5, 0)))]
    device = sc.Device(
        "two_films", layers=layers, films=films, holes=holes, abstract_regions=abstract,
        solve_dtype=solve_dtype,
    )
    device.make_mesh(max_edge_length=0.8)
    return device


def _solve_both(ref_device, iterations=2):
    port_device = st.device_from_reference(ref_device)
    kwargs = dict(circulating_currents=CIRC, iterations=iterations, field_units="mT",
                  current_units="uA")
    ref = sc.solve(ref_device, applied_field=sc.sources.ConstantField(0.3), **kwargs)[-1]
    port = st.solve(
        port_device, applied_field=st.sources.ConstantField(0.3), torch_device="cpu", **kwargs
    )[-1]
    return ref, port


@pytest.fixture(scope="module")
def solutions():
    ref_device = _two_films()
    ref, port = _solve_both(ref_device)
    ref.device.solve_dtype = ref_device.solve_dtype
    return ref, port


def _mag(value):
    return np.asarray(getattr(value, "magnitude", value), dtype=float)


def _assert_close(got, expected, rtol=RTOL):
    got, expected = _mag(got), _mag(expected)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=rtol * max(np.abs(expected).max(), 1e-300))


def _points(seed=2, m=60, radius=5.5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-radius, radius, (m, 2))


def test_solved_streams_agree(solutions):
    ref, port = solutions
    for name, fs in ref.film_solutions.items():
        _assert_close(port.film_solutions[name].stream, fs.stream)
        _assert_close(port.film_solutions[name].total_field, fs.total_field)


def test_properties_and_device_copy(solutions):
    ref, port = solutions
    assert (port.field_units, port.current_units) == (ref.field_units, ref.current_units)
    assert port.solver == "superscreen_tpu_torch.solve"
    assert set(port.version_info) >= {"numpy", "torch"}
    assert port.time_created is not None
    assert port.torch_device == torch.device("cpu")
    with pytest.raises(AttributeError):
        port.field_units = "T"
    assert port.device.solve_dtype == np.float64
    assert port.device.meshes["ring"].spatial_index("cpu") is port.device.meshes[
        "ring"
    ].spatial_index(torch.device("cpu"))


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("film", ["ring", "disk"])
def test_interp_current_density(solutions, method, film):
    ref, port = solutions
    pts = _points()
    expected = ref.interp_current_density(pts, film=film, method=method)
    got = port.interp_current_density(pts, film=film, method=method)
    assert (expected == 0).all(axis=1).any() and (expected != 0).any()
    _assert_close(got, expected)
    with_units = port.interp_current_density(
        pts, film=film, method=method, units="mA / mm", with_units=True
    )
    _assert_close(
        with_units,
        ref.interp_current_density(pts, film=film, method=method, units="mA / mm", with_units=True),
    )


def test_interp_rejects_unknown_method(solutions):
    _, port = solutions
    with pytest.raises(ValueError, match="interpolation method"):
        port.interp_current_density(_points(), film="ring", method="quintic")


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_current_through_path(solutions, method):
    ref, port = solutions
    path = np.stack([np.linspace(2.1, 4.9, 41), np.full(41, 0.3)], axis=1)
    expected = ref.current_through_path(path, film="ring", interp_method=method)
    got = port.current_through_path(path, film="ring", interp_method=method)
    assert abs(_mag(expected)) > 0.1
    _assert_close(got, expected)
    two_points = np.array([[2.5, -1.0], [4.5, -1.2]])
    _assert_close(
        port.current_through_path(two_points, film="ring", units="mA", with_units=False),
        ref.current_through_path(two_points, film="ring", units="mA", with_units=False),
    )


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize(
    "dataset", ["field", "self_field", "applied_field", "field_from_other_films"]
)
def test_interp_field(solutions, dataset, method):
    ref, port = solutions
    pts = _points(seed=4)
    for film in ("ring", "disk"):
        expected = ref.interp_field(pts, film=film, dataset=dataset, method=method)
        got = port.interp_field(pts, film=film, dataset=dataset, method=method)
        np.testing.assert_array_equal(np.isnan(_mag(expected)), np.isnan(_mag(got)))
        inside = np.isfinite(_mag(expected))
        _assert_close(_mag(got)[inside], _mag(expected)[inside])
    _assert_close(
        _mag(port.interp_field(pts[:5] * 0.3, film="disk", units="uT", with_units=True)),
        _mag(ref.interp_field(pts[:5] * 0.3, film="disk", units="uT", with_units=True)),
    )


def test_interp_field_rejects_unknown_dataset(solutions):
    _, port = solutions
    with pytest.raises(ValueError, match="Invalid dataset"):
        port.interp_field(_points(), film="ring", dataset="bogus")


def test_interp_field_from_other_films_of_an_uncoupled_solution():
    ref_device = _two_films()
    ref, port = _solve_both(ref_device, iterations=0)
    pts = _points(seed=6, radius=2.5)
    assert port.film_solutions["disk"].field_from_other_films is None
    _assert_close(
        port.interp_field(pts, film="disk", dataset="field_from_other_films"),
        ref.interp_field(pts, film="disk", dataset="field_from_other_films"),
    )


@pytest.mark.parametrize("name", ["ring", "disk", "hole", "patch"])
def test_polygon_flux(solutions, name):
    ref, port = solutions
    _assert_close(port.polygon_flux(name), ref.polygon_flux(name))
    _assert_close(
        port.polygon_flux(name, units="Phi_0", with_units=False),
        ref.polygon_flux(name, units="Phi_0", with_units=False),
    )


def test_polygon_flux_rejects_unknown_polygon(solutions):
    _, port = solutions
    with pytest.raises(ValueError, match="Unknown polygon"):
        port.polygon_flux("nowhere")


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_polygon_fluxoid(solutions, method):
    ref, port = solutions
    contour = geo.circle(3.2, points=80)
    expected = ref.polygon_fluxoid(contour, film="ring", interp_method=method)
    got = port.polygon_fluxoid(contour, film="ring", interp_method=method)
    assert isinstance(got, st.Fluxoid)
    _assert_close(got.flux_part, expected.flux_part)
    _assert_close(got.supercurrent_part, expected.supercurrent_part)
    as_polygon = st.Polygon(points=contour)
    natural = port.polygon_fluxoid(as_polygon, film="ring", units=None, with_units=False)
    natural_ref = ref.polygon_fluxoid(
        sc.Polygon(points=contour), film="ring", units=None, with_units=False
    )
    _assert_close(natural.flux_part, natural_ref.flux_part)
    _assert_close(natural.supercurrent_part, natural_ref.supercurrent_part)


def test_polygon_fluxoid_rejects_a_contour_outside_the_film(solutions):
    _, port = solutions
    with pytest.raises(ValueError, match="not contained within the film"):
        port.polygon_fluxoid(geo.circle(6.0, points=40), film="ring")


def test_hole_fluxoid(solutions):
    ref, port = solutions
    expected = ref.hole_fluxoid("hole")
    got = port.hole_fluxoid("hole")
    _assert_close(got.flux_part, expected.flux_part)
    _assert_close(got.supercurrent_part, expected.supercurrent_part)
    contour = geo.circle(3.0, points=50)
    expected = ref.hole_fluxoid("hole", points=contour, interp_method="cubic", units="mT * um**2")
    got = port.hole_fluxoid("hole", points=contour, interp_method="cubic", units="mT * um**2")
    _assert_close(sum(got), sum(expected))
    with pytest.raises(ValueError, match="not completely enclosed"):
        port.hole_fluxoid("hole", points=geo.circle(1.0, points=20))


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("heights", ["scalar", "array", "xyz", "in_plane", "mixed_planes"])
def test_screening_field_at_position(solutions, vector, heights):
    ref, port = solutions
    pts = _points(seed=8, m=45)
    rng = np.random.default_rng(9)
    if heights == "scalar":
        args, kwargs = (pts,), dict(zs=2.5)
    elif heights == "array":
        args, kwargs = (pts,), dict(zs=rng.uniform(1.5, 4.0, len(pts)))
    elif heights == "xyz":
        args, kwargs = (np.column_stack([pts, rng.uniform(-2.0, -0.5, len(pts))]),), {}
    elif heights == "in_plane":
        # z = 1 is the disk's plane: points inside it are interpolated, the
        # others and the whole ring are summed.
        args, kwargs = (pts,), dict(zs=1.0)
    else:
        args, kwargs = (pts,), dict(zs=rng.choice([0.0, 1.0, 2.0], len(pts)))
    expected = ref.screening_field_at_position(*args, vector=vector, **kwargs)
    got = port.screening_field_at_position(*args, vector=vector, **kwargs)
    assert _mag(got).shape == ((len(pts), 3) if vector else (len(pts),))
    _assert_close(got, expected)
    per_film = port.screening_field_at_position(
        *args, vector=vector, units="uT", with_units=False, return_sum=False, **kwargs
    )
    per_film_ref = ref.screening_field_at_position(
        *args, vector=vector, units="uT", with_units=False, return_sum=False, **kwargs
    )
    assert set(per_film) == {"ring", "disk"}
    scale = max(np.abs(v).max() for v in per_film_ref.values())
    for name in per_film:
        np.testing.assert_allclose(per_film[name], per_film_ref[name], rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("heights", ["scalar", "in_plane", "mixed_planes"])
def test_field_at_position(solutions, heights, method):
    ref, port = solutions
    pts = _points(seed=10, m=45)
    rng = np.random.default_rng(12)
    zs = {"scalar": 1.75, "in_plane": 0.0,
          "mixed_planes": rng.choice([0.0, 1.0, 3.0], len(pts))}[heights]
    expected = ref.field_at_position(pts, zs=zs, interp_method=method)
    got = port.field_at_position(pts, zs=zs, interp_method=method)
    _assert_close(got, expected)
    parts = port.field_at_position(pts, zs=zs, interp_method=method, units="mT",
                                   with_units=False, return_sum=False)
    parts_ref = ref.field_at_position(pts, zs=zs, interp_method=method, units="mT",
                                      with_units=False, return_sum=False)
    assert set(parts) == {"ring", "disk", "applied_field"}
    for name in parts:
        np.testing.assert_allclose(parts[name], parts_ref[name], rtol=0,
                                   atol=RTOL * np.abs(_mag(expected)).max())


def test_vector_potential_at_position(solutions):
    ref, port = solutions
    pts = _points(seed=14, m=40)
    for kwargs in (dict(zs=2.0), dict(zs=np.linspace(1.5, 3.0, len(pts)))):
        expected = ref.vector_potential_at_position(pts, **kwargs)
        got = port.vector_potential_at_position(pts, **kwargs)
        assert _mag(got).shape == (len(pts), 3)
        _assert_close(got, expected)
    xyz = np.column_stack([pts, np.full(len(pts), -1.0)])
    parts = port.vector_potential_at_position(xyz, units="uT * um", with_units=False,
                                              return_sum=False)
    parts_ref = ref.vector_potential_at_position(xyz, units="uT * um", with_units=False,
                                                 return_sum=False)
    for name in parts_ref:
        _assert_close(parts[name], parts_ref[name])
    # Points on the mesh sites of the ring, evaluated at the disk's plane
    # above: a query that coincides in (x, y) with a site.
    sites = port.device.meshes["disk"].sites[:10] * 1.5
    _assert_close(
        port.vector_potential_at_position(sites, zs=0.5),
        ref.vector_potential_at_position(sites, zs=0.5),
    )


def test_vector_potential_inside_a_film_raises_or_warns(solutions, caplog):
    _, port = solutions
    inside = np.array([[3.0, 0.5], [-3.5, 1.0]])
    with pytest.raises(ValueError, match="inside the film"):
        port.vector_potential_at_position(inside, zs=0.0)
    with caplog.at_level("WARNING", logger="solution"):
        out = port.vector_potential_at_position(np.array([[3.0, 0.5], [9.0, 9.0]]), zs=0.0)
    assert "mesh-regularized" in caplog.text
    assert np.isfinite(_mag(out)).all()


@pytest.mark.parametrize(
    "method", ["screening_field_at_position", "field_at_position", "vector_potential_at_position"]
)
def test_zs_validation(solutions, method):
    _, port = solutions
    call = getattr(port, method)
    with pytest.raises(ValueError, match="zs must be provided"):
        call(_points(m=4))
    with pytest.raises(ValueError, match="zs cannot be given"):
        call(np.ones((4, 3)), zs=1.0)


def test_film_solution_and_solution_equality(solutions):
    _, port = solutions
    fs = port.film_solutions["ring"]
    same = st.FilmSolution(fs.stream.copy(), fs.current_density.copy(), fs.applied_field.copy(),
                           fs.self_field.copy(), fs.field_from_other_films.copy())
    assert fs.is_close(same) and fs == same
    assert fs != st.FilmSolution(fs.stream * 1.01, fs.current_density, fs.applied_field,
                                 fs.self_field, fs.field_from_other_films)
    assert fs != st.FilmSolution(fs.stream, fs.current_density, fs.applied_field, fs.self_field)
    assert fs.__eq__(3) is NotImplemented
    clone = st.Solution(
        device=port.device, film_solutions=dict(port.film_solutions),
        applied_field_func=port.applied_field_func, field_units=port.field_units,
        current_units=port.current_units, circulating_currents=port.circulating_currents,
        torch_device="cpu",
    )
    assert port.equals(clone) and clone.equals(port) and port.equals(port)
    assert not port.equals(clone, require_same_timestamp=True) and port != clone
    assert not port.equals("solution")
    other = st.Solution(
        device=port.device, film_solutions=dict(port.film_solutions),
        applied_field_func=port.applied_field_func, field_units=port.field_units,
        current_units=port.current_units, circulating_currents={"hole": 5.0},
        torch_device="cpu",
    )
    assert not port.equals(other)


def test_device_copy_and_mesh_helpers(solutions):
    _, port = solutions
    device = port.device
    shared, deep = device.copy(), device.copy(copy_mesh=True)
    assert shared == device and deep == device
    assert shared.meshes["ring"] is device.meshes["ring"]
    assert deep.meshes["ring"] is not device.meshes["ring"]
    np.testing.assert_array_equal(deep.meshes["ring"].sites, device.meshes["ring"].sites)
    assert device.copy(with_mesh=False).meshes is None
    assert [p.name for p in device.get_polygons()] == ["ring", "disk", "hole", "patch"]
    renamed = device.copy()
    renamed.layers["top"].z0 = 2.0
    assert renamed != device
    mesh = device.meshes["ring"]
    assert mesh.closest_site(mesh.sites[17] + 1e-6) == 17


def test_mesh_vertex_gradient_matches_reference():
    ref_device = _two_films()
    port_device = st.device_from_reference(ref_device)
    for name, mesh in ref_device.meshes.items():
        values = np.sin(mesh.sites[:, 0]) + mesh.sites[:, 1] ** 2
        expected = mesh.vertex_gradient(values)
        got = port_device.meshes[name].vertex_gradient(values)
        np.testing.assert_allclose(got, expected, rtol=0, atol=1e-12 * np.abs(expected).max())


def test_float32_device_and_a_height_float32_does_not_represent():
    """A float32 device with a layer at z0 = 0.1, which float32 does not
    represent: whether a query at zs = 0.1 counts as in the plane rests on
    ``np.full(..., 0.1, dtype=float32) == 0.1`` (True under NumPy 2's weak
    Python scalars, False before), and both packages must decide alike,
    film by film.  The port's Solution is built from the reference's own
    float32 arrays, so only the post-processing is compared."""
    ref_device = _two_films(solve_dtype="float32", z_top=0.1)
    ref = sc.solve(ref_device, applied_field=sc.sources.ConstantField(0.3),
                   circulating_currents=CIRC, iterations=1)[-1]
    port = st.Solution(
        device=st.device_from_reference(ref_device),
        film_solutions={
            name: st.FilmSolution(
                *(np.array(getattr(fs, key)) for key in (
                    "stream", "current_density", "applied_field", "self_field",
                    "field_from_other_films"))
            )
            for name, fs in ref.film_solutions.items()
        },
        applied_field_func=st.sources.ConstantField(0.3),
        field_units=ref.field_units, current_units=ref.current_units,
        circulating_currents=ref.circulating_currents, torch_device="cpu",
    )
    assert port.device.solve_dtype == ref.device.solve_dtype == np.float32
    # Strictly inside the disk and away from its mesh sites' heights.
    pts = _points(seed=16, m=30, radius=1.8)
    for zs in (0.1, 0.0, 0.75):
        expected = _mag(ref.field_at_position(pts, zs=zs))
        got = _mag(port.field_at_position(pts, zs=zs))
        assert got.dtype == expected.dtype
        np.testing.assert_allclose(got, expected, rtol=0, atol=2e-6 * np.abs(expected).max())
    # At zs = 0.1 both interpolate in the disk or both sum its sites at
    # dz ~ 1.5e-9: the parts agree film by film.
    parts = port.screening_field_at_position(pts, zs=0.1, with_units=False, return_sum=False)
    parts_ref = ref.screening_field_at_position(pts, zs=0.1, with_units=False, return_sum=False)
    for name, expected in parts_ref.items():
        np.testing.assert_allclose(parts[name], expected, rtol=0,
                                   atol=2e-6 * np.abs(expected).max())

"""The port's host layer (point-in-polygon, meshing, FEM operators, dense
operator assembly) against the JAX package's, on one mesh."""

import numpy as np
import pytest
import torch
from matplotlib.path import Path

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu_torch.device.polygon import points_in_ring

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ring_pair():
    """The README quickstart ring, meshed by the JAX package, and its
    counterpart in the port on the identical mesh."""
    layer = sc.Layer("base", london_lambda=0.08, thickness=0.1, z0=0)
    film = sc.Polygon("ring", layer="base", points=sc.geometry.circle(4))
    hole = sc.Polygon("hole", layer="base", points=sc.geometry.circle(2))
    ref = sc.Device("ring", layers=[layer], films=[film], holes=[hole], solve_dtype="float64")
    ref.make_mesh(max_edge_length=0.9)
    return ref, st.device_from_reference(ref)


def _dense(coo):
    out = np.zeros(coo.shape)
    np.add.at(out, (coo.rows, coo.cols), coo.vals)
    return out


@pytest.mark.parametrize("polygon", ["ring", "hole"])
def test_points_in_ring_matches_matplotlib_on_mesh_vertices(ring_pair, polygon):
    # Film and hole outlines are mesh vertices, so many queries lie exactly
    # on an edge: the decision there must be matplotlib's.
    ref, _ = ring_pair
    poly = ref.films.get(polygon) or ref.holes[polygon]
    sites = ref.meshes["ring"].sites
    expected = Path(poly.points, closed=True).contains_points(sites)
    np.testing.assert_array_equal(points_in_ring(poly.points, sites), expected)


def test_points_in_ring_matches_matplotlib_on_random_and_vertex_points():
    rng = np.random.default_rng(0)
    ring = sc.geometry.close_curve(sc.geometry.circle(2.0, points=37))
    queries = np.concatenate([rng.uniform(-3, 3, size=(500, 2)), ring, 0.5 * (ring[1:] + ring[:-1])])
    expected = Path(ring, closed=True).contains_points(queries)
    np.testing.assert_array_equal(points_in_ring(ring, queries), expected)


@pytest.mark.parametrize("name", ["vertex_areas", "triangle_areas", "boundary_indices"])
def test_mesh_arrays_match(ring_pair, name):
    ref, port = ring_pair
    a = getattr(ref.meshes["ring"], name)
    b = getattr(port.meshes["ring"], name)
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=0)


@pytest.mark.parametrize("op", ["laplacian", "gradient_x", "gradient_y"])
def test_fem_operators_match(ring_pair, op):
    ref, port = ring_pair
    a = _dense(getattr(ref.meshes["ring"].operators, op))
    b_coo = getattr(port.meshes["ring"].operators, op)
    b = b_coo.to_dense(torch.float64, "cpu").numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.abs(a).max())
    x = np.random.default_rng(1).standard_normal(a.shape[1])
    np.testing.assert_allclose(
        b_coo.matvec(torch.as_tensor(x)).numpy(), a @ x, rtol=1e-12, atol=1e-12 * np.abs(a @ x).max()
    )


def test_Q_dense_matches_reference(ring_pair):
    ref, port = ring_pair
    a = np.asarray(ref.meshes["ring"].operators.Q_dense("float64"))
    b = port.meshes["ring"].operators.Q_dense(torch.float64, "cpu").numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("buffer", [0, None])
def test_port_make_mesh_is_valid(buffer):
    film = st.Polygon("disk", layer="l", points=st.geometry.circle(3.0, points=60))
    hole = st.Polygon("hole", layer="l", points=st.geometry.circle(1.0, points=30))
    device = st.Device(
        "d", layers=[st.Layer("l", Lambda=0.5)], films=[film], holes=[hole], solve_dtype="float64"
    )
    kwargs = {"buffer": 0} if buffer == 0 else {}
    device.make_mesh(max_edge_length=0.6, **kwargs)
    mesh = device.meshes["disk"]
    assert 100 < len(mesh.sites) < 2000
    assert np.all(mesh.triangle_areas > 0)
    assert mesh.elements.min() == 0 and mesh.elements.max() == len(mesh.sites) - 1
    if buffer == 0:
        # The mesh covers exactly the film polygon (holes are meshed too).
        np.testing.assert_allclose(mesh.vertex_areas.sum(), film.area, rtol=1e-12)
    else:
        assert mesh.vertex_areas.sum() > film.area
    lap = mesh.operators.laplacian
    row_sums = lap.matvec(torch.ones(len(mesh.sites), dtype=torch.float64)).numpy()
    assert np.abs(row_sums).max() <= 1e-9 * np.abs(lap.vals).max()
    # The hole is meshed: some sites lie in it, most outside it.
    in_hole = hole.contains_points(mesh.sites)
    assert 0 < in_hole.sum() < len(mesh.sites)


@pytest.mark.parametrize("closed", [True, False])
def test_in_polygon_matches_matplotlib(closed):
    from superscreen_tpu_torch.ops.fem import in_polygon

    ring = sc.geometry.circle(1.5, points=23)
    queries = np.random.default_rng(4).uniform(-2, 2, size=(300, 2))
    expected = Path(sc.geometry.close_curve(ring), closed=True).contains_points(queries)
    poly = sc.geometry.close_curve(ring) if closed else ring
    np.testing.assert_array_equal(in_polygon(poly, queries), expected)
    assert in_polygon(poly, (0.0, 0.0)) is True

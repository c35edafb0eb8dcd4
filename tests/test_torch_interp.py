"""The port's triangle index, point location and interpolants against
``superscreen_tpu.ops.interp`` on the same mesh and the same seeded query
points, at float64 on the CPU."""

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
from superscreen_tpu.ops import interp as ref_interp
from superscreen_tpu_torch.ops import interp as port_interp

torch.set_num_threads(2)

# Both sides evaluate the same float64 expressions; sums differ in order.
TOL = 1e-12


@pytest.fixture(scope="module")
def mesh():
    """A ring mesh of a few hundred sites (the hole is not meshed out: the
    index covers the convex region plus a margin)."""
    layers = [sc.Layer("base", Lambda=1, z0=0)]
    films = [sc.Polygon("ring", layer="base", points=geo.circle(4, points=60))]
    holes = [sc.Polygon("hole", layer="base", points=geo.circle(1.5, points=30))]
    device = sc.Device("ring", layers=layers, films=films, holes=holes)
    device.make_mesh(max_edge_length=0.6)
    return device.meshes["ring"]


@pytest.fixture(scope="module")
def indices(mesh):
    return (
        ref_interp.build_triangle_index(mesh.sites, mesh.elements),
        port_interp.build_triangle_index(mesh.sites, mesh.elements, "cpu"),
    )


def _queries(mesh, kind):
    rng = np.random.default_rng(11)
    sites, elements = mesh.sites, mesh.elements
    if kind == "inside":
        w = rng.dirichlet(np.ones(3), size=400)
        tris = sites[elements[rng.integers(0, len(elements), 400)]]
        return np.einsum("ki,kij->kj", w, tris)
    if kind == "edges":
        tris = elements[rng.integers(0, len(elements), 300)]
        t = rng.uniform(0, 1, (300, 1))
        return t * sites[tris[:, 0]] + (1 - t) * sites[tris[:, 1]]
    if kind == "vertices":
        return sites[rng.integers(0, len(sites), 200)]
    lo, hi = sites.min(axis=0), sites.max(axis=0)
    outside = rng.uniform(lo - 2, hi + 2, (400, 2))
    return outside[np.linalg.norm(outside, axis=1) > 5.0]


def _fields(mesh):
    x, y = mesh.sites.T
    scalar = np.sin(0.7 * x) * np.cos(0.4 * y) + 0.1 * x * y
    vector = np.stack([np.cos(x) + y, x**2 - 0.3 * y], axis=1)
    return scalar, vector


def test_index_matches_reference(indices):
    ref, port = indices
    assert tuple(int(v) for v in np.asarray(ref.grid_dims)) == port.grid_dims
    np.testing.assert_array_equal(np.asarray(ref.cell_tris), port.cell_tris.numpy())
    np.testing.assert_array_equal(np.asarray(ref.elements), port.elements.numpy())
    np.testing.assert_allclose(np.asarray(ref.tri_verts), port.tri_verts.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(ref.origin), port.origin.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(ref.inv_step), port.inv_step.numpy(), rtol=TOL)
    assert port.tri_verts.dtype == torch.float64


@pytest.mark.parametrize("kind", ["inside", "edges", "vertices", "outside"])
def test_locate_found_mask_and_weights(mesh, indices, kind):
    """The found-mask must agree; the triangle may differ on a shared edge
    (a tie), so the weights are compared through the point they give."""
    ref, port = indices
    pts = _queries(mesh, kind)
    tri_r, bary_r, found_r = (np.asarray(a) for a in ref_interp.locate(ref, pts))
    tri_p, bary_p, found_p = (a.numpy() for a in port_interp.locate(port, torch.as_tensor(pts)))
    np.testing.assert_array_equal(found_r, found_p)
    assert found_p.all() == (kind != "outside")
    if kind != "outside":
        rebuilt = np.einsum("ki,kij->kj", bary_p, mesh.sites[mesh.elements[tri_p]])
        np.testing.assert_allclose(rebuilt, pts, atol=TOL * 10)
        assert (bary_p.min(axis=1) >= -1e-6).all()


@pytest.mark.parametrize("kind", ["inside", "edges", "vertices", "outside"])
@pytest.mark.parametrize("data", ["scalar", "vector"])
def test_interp_linear_matches_reference(mesh, indices, kind, data):
    ref, port = indices
    values = _fields(mesh)[data == "vector"]
    pts = _queries(mesh, kind)
    expected = np.asarray(ref_interp.interp_linear(ref, values, pts))
    got = port_interp.interp_linear(port, values, pts).numpy()
    assert got.shape == expected.shape
    np.testing.assert_array_equal(np.isnan(expected), np.isnan(got))
    np.testing.assert_allclose(got, expected, rtol=0, atol=TOL * np.abs(values).max())


@pytest.mark.parametrize("kind", ["inside", "edges", "vertices", "outside"])
def test_interp_cubic_matches_reference(mesh, indices, kind):
    ref, port = indices
    values, _ = _fields(mesh)
    gradients = mesh.vertex_gradient(values)
    pts = _queries(mesh, kind)
    expected = np.asarray(ref_interp.interp_cubic(ref, values, gradients, pts))
    got = port_interp.interp_cubic(port, values, gradients, pts).numpy()
    np.testing.assert_array_equal(np.isnan(expected), np.isnan(got))
    np.testing.assert_allclose(got, expected, rtol=0, atol=TOL * np.abs(values).max())


def test_linear_interpolant_returns_site_values(mesh, indices):
    _, port = indices
    values, _ = _fields(mesh)
    got = port_interp.interp_linear(port, values, mesh.sites).numpy()
    np.testing.assert_allclose(got, values, rtol=0, atol=1e-12)


def test_fill_value_and_output_dtype(mesh, indices):
    _, port = indices
    values, vector = _fields(mesh)
    far = np.array([[50.0, 50.0], [0.1, 0.2]])
    out = port_interp.interp_linear(port, values.astype(np.float32), far, fill=-7.0)
    assert out.dtype == torch.float32 and float(out[0]) == -7.0
    assert port_interp.interp_linear(port, vector, far).dtype == torch.float64
    ints = np.arange(len(values))
    assert port_interp.interp_linear(port, ints, far).dtype == torch.float64


def test_float32_data_is_located_in_float64(mesh, indices):
    """float32 data on a shared edge: the weights stay float64, so the
    query is found and only the values are rounded."""
    _, port = indices
    values, _ = _fields(mesh)
    pts = _queries(mesh, "edges")
    exact = port_interp.interp_linear(port, values, pts).numpy()
    rounded = port_interp.interp_linear(port, values.astype(np.float32), pts).numpy()
    assert np.isfinite(rounded).all()
    np.testing.assert_allclose(rounded, exact, rtol=0, atol=2e-7 * np.abs(values).max())


def test_queries_run_in_chunks(mesh, indices, monkeypatch):
    _, port = indices
    values, _ = _fields(mesh)
    pts = _queries(mesh, "inside")
    whole = port_interp.interp_linear(port, values, pts)
    monkeypatch.setattr(port_interp, "QUERY_CHUNK", 37)
    assert torch.equal(port_interp.interp_linear(port, values, pts), whole)


def test_locate_refuses_float32_points(indices):
    _, port = indices
    with pytest.raises(ValueError, match="float64"):
        port_interp.locate(port, torch.zeros((3, 2), dtype=torch.float32))

"""The port's top-level ``distance`` and ``fem`` modules, its
``MeshOperators`` conveniences and the kernel helper ``cdist``, against the JAX package's on the same seeded inputs
and mesh at float64 on the CPU (1e-12, relative to the largest entry)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu import distance as ref_distance
from superscreen_tpu import fem as ref_fem
from superscreen_tpu_torch import distance, fem
from superscreen_tpu_torch.ops import kernels

torch.set_num_threads(2)

TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture(scope="module")
def mesh():
    ref = sc.Polygon("disk", layer="l", points=sc.geometry.circle(1, points=60)).make_mesh(
        max_edge_length=0.15, build_operators=True
    )
    return st.Mesh.from_triangulation(ref.sites, ref.elements), ref


@pytest.mark.parametrize("name", [
    "sqeuclidean_distance_2d", "sqeuclidean_distance_3d",
    "euclidean_distance_2d", "euclidean_distance_3d",
])
def test_pairwise_distances_match(name):
    dim = int(name[-2])
    rng = np.random.default_rng(dim)
    XA, XB = rng.normal(size=(37, dim)), rng.normal(size=(23, dim))
    _close(getattr(distance, name)(XA, XB), getattr(ref_distance, name)(XA, XB))
    with pytest.raises(ValueError):
        getattr(distance, name)(XA[:, :1], XB[:, :1])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_cdist_matches(dim, metric):
    rng = np.random.default_rng(dim + 7)
    XA, XB = rng.normal(size=(41, dim)), rng.normal(size=(19, dim))
    got = distance.cdist(XA, XB, metric=metric, torch_device="cpu")
    assert isinstance(got, np.ndarray)
    _close(got, ref_distance.cdist(XA, XB, metric=metric))
    _close(kernels.cdist(torch.as_tensor(XA), torch.as_tensor(XB), metric=metric).numpy(), got)


def test_cdist_rejects_bad_input():
    a = np.zeros((3, 2))
    for call in (
        lambda: distance.cdist(a, a, metric="cosine"),
        lambda: distance.cdist(a, np.zeros((3, 3))),
        lambda: distance.cdist(np.zeros((3, 4)), np.zeros((3, 4))),
    ):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("dtype", [None, np.float64, np.float32])
def test_q_matrix_matches(dtype):
    rng = np.random.default_rng(11)
    points = rng.uniform(-3, 3, (300, 2))
    got = distance.q_matrix(points, dtype=dtype, torch_device="cpu")
    want = np.asarray(ref_distance.q_matrix(points, dtype=dtype))
    assert got.dtype == want.dtype
    _close(got, want, 1e-6 if dtype == np.float32 else TOL)
    assert np.all(np.diag(got) == 0)


def test_q_matrix_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distance.q_matrix(np.zeros((3, 2)))


@pytest.mark.parametrize("call", [
    lambda: distance.cdist(np.zeros((3, 2)), np.zeros((4, 2))),
    lambda: st.MeshOperators.C_vector(np.zeros((3, 2))),
], ids=["cdist", "C_vector"])
def test_host_in_host_out_helpers_without_a_card_raise(call):
    """NumPy in and out, but computed on the card unless the caller asks
    for the CPU: without one they raise, with no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_mesh_operators_conveniences_match(mesh):
    port, ref = mesh
    ops = port.operators
    C = st.MeshOperators.C_vector(port.sites, torch_device="cpu")
    _close(C, ref.operators.C_vector(ref.sites))
    Q = st.MeshOperators.Q_matrix(port.sites, port.vertex_areas, torch_device="cpu")
    assert isinstance(Q, np.ndarray)
    _close(Q, ref.operators.Q_matrix(ref.sites, ref.vertex_areas))
    _close(ops.Q("cpu").numpy(), np.asarray(ref.operators.Q))
    clone = ops.copy()
    assert clone is not ops and clone.sites is not ops.sites
    np.testing.assert_array_equal(clone.laplacian.vals, ops.laplacian.vals)


@pytest.mark.parametrize("name", ["triangle_areas", "vertex_areas", "centroids"])
def test_fem_geometry_matches(mesh, name):
    port, _ = mesh
    _close(getattr(fem, name)(port.sites, port.elements),
           getattr(ref_fem, name)(port.sites, port.elements))


def test_edge_lengths_match(mesh):
    from superscreen_tpu.device import mesh_generation as ref_mgen

    port, _ = mesh
    _close(st.device.get_edge_lengths(port.sites, port.elements),
           ref_mgen.get_edge_lengths(port.sites, port.elements))
    _close(st.device.get_edge_lengths(port.sites, port.elements), port.edge_mesh.edge_lengths)


@pytest.mark.parametrize("sparse", [False, True])
def test_adjacency_matrix_matches(mesh, sparse):
    port, _ = mesh
    got = fem.adjacency_matrix(port.elements, sparse=sparse)
    want = ref_fem.adjacency_matrix(port.elements, sparse=sparse)
    if sparse:
        got, want = st.ops.fem.coo_to_dense(got), want.to_dense()
    np.testing.assert_array_equal(got, want)


def test_adj_directed_tri_indices_matches(mesh):
    port, _ = mesh
    got = fem.adj_directed_tri_indices(port.elements, len(port.sites))
    want = ref_fem.adj_directed_tri_indices(port.elements, len(port.sites))
    np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("method", ["uniform", "inv_euclidean", "half_cotangent"])
@pytest.mark.parametrize("sparse", [False, True])
def test_calculate_weights_matches(mesh, method, sparse):
    port, _ = mesh
    got = fem.calculate_weights(port.sites, port.elements, method, sparse=sparse)
    want = ref_fem.calculate_weights(port.sites, port.elements, method, sparse=sparse)
    if sparse:
        got, want = st.ops.fem.coo_to_dense(got), want.to_dense()
    _close(got, want)


@pytest.mark.parametrize("name", ["weights_inv_euclidean", "weights_half_cotangent"])
@pytest.mark.parametrize("sparse", [False, True])
def test_weight_matrices_match(mesh, name, sparse):
    port, _ = mesh
    got = getattr(fem, name)(port.sites, port.elements, sparse=sparse)
    want = getattr(ref_fem, name)(port.sites, port.elements, sparse=sparse)
    if sparse:
        assert sp.issparse(got)
        got, want = got.toarray(), want.toarray()
    _close(got, want)


@pytest.mark.parametrize("weight_method", ["uniform", "inv_euclidean", "half_cotangent"])
def test_laplace_operator_matches(mesh, weight_method):
    port, _ = mesh
    masses = fem.vertex_areas(port.sites, port.elements)
    _close(
        fem.laplace_operator(port.sites, port.elements, masses=masses, weight_method=weight_method),
        ref_fem.laplace_operator(port.sites, port.elements, masses=masses,
                                 weight_method=weight_method),
    )


@pytest.mark.parametrize("name", ["gradient_triangles", "gradient_vertices"])
def test_gradients_match(mesh, name):
    port, _ = mesh
    for got, want in zip(getattr(fem, name)(port.sites, port.elements),
                         getattr(ref_fem, name)(port.sites, port.elements)):
        _close(got, want)


def test_in_polygon_and_coo_transpose_match(mesh):
    port, _ = mesh
    rng = np.random.default_rng(5)
    query = rng.uniform(-1.2, 1.2, (500, 2))
    ring = sc.geometry.circle(0.7, points=25)
    np.testing.assert_array_equal(fem.in_polygon(ring, query), ref_fem.in_polygon(ring, query))
    assert fem.in_polygon(ring, (0.0, 0.0)) is True
    lap = port.operators.gradient_tri_x
    np.testing.assert_array_equal(
        st.ops.fem.coo_to_dense(lap.T), st.ops.fem.coo_to_dense(lap).T
    )

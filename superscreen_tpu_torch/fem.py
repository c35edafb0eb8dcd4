"""Top-level FEM API.

Counterpart of ``superscreen_tpu/fem.py``: thin wrappers around
:mod:`superscreen_tpu_torch.ops.fem` that return the JAX package's dense
NumPy and SciPy types, while the solver itself uses the COO forms.  All of
it runs on the host.
"""

from typing import Literal, Optional, Tuple

import numpy as np

from .ops import fem as _fem

__all__ = [
    "triangle_areas",
    "in_polygon",
    "centroids",
    "adjacency_matrix",
    "adj_directed_tri_indices",
    "calculate_weights",
    "weights_inv_euclidean",
    "weights_half_cotangent",
    "laplace_operator",
    "gradient_triangles",
    "gradient_vertices",
    "vertex_areas",
]

triangle_areas = _fem.triangle_areas
vertex_areas = _fem.vertex_areas
in_polygon = _fem.in_polygon
centroids = _fem.centroids
adjacency_matrix = _fem.adjacency_matrix


def adj_directed_tri_indices(triangles: np.ndarray, num_sites: int):
    """Directed adjacency matrix whose entry ``(i, j)`` is ``1 +`` the index
    of a triangle containing the directed edge ``i -> j`` (zero where no edge
    exists)."""
    import scipy.sparse as sp

    triangles = np.asarray(triangles)
    m = triangles.shape[0]
    # Each triangle (a, b, c) contributes directed edges a->b, b->c, c->a.
    src = triangles.ravel()
    dst = np.roll(triangles, -1, axis=1).ravel()
    tri_ids = np.repeat(np.arange(1, m + 1), 3)
    return sp.csc_array((tri_ids, (src, dst)), shape=(num_sites, num_sites))


def weights_inv_euclidean(
    points: np.ndarray, triangles: np.ndarray, sparse: bool = True
):
    """Edge weights ``w_ij = 1/|r_i - r_j|`` over mesh edges. Returns a
    scipy sparse array when ``sparse`` is True."""
    return _weights_matrix(points, triangles, "inv_euclidean", sparse)


def weights_half_cotangent(
    points: np.ndarray, triangles: np.ndarray, sparse: bool = True
):
    """Half-cotangent edge weights. Returns a scipy sparse array when
    ``sparse`` is True."""
    return _weights_matrix(points, triangles, "half_cotangent", sparse)


def _weights_matrix(points, triangles, method: str, sparse: bool):
    coo = _fem._weights_coo(points, triangles, method)
    if not sparse:
        return _fem.coo_to_dense(coo)
    import scipy.sparse as sp

    n = len(points)
    mat = sp.coo_array((coo.vals, (coo.rows, coo.cols)), shape=(n, n))
    mat.sum_duplicates()
    return mat.tolil()


def calculate_weights(
    points: np.ndarray,
    triangles: np.ndarray,
    method: str,
    sparse: bool = False,
) -> np.ndarray:
    """The edge-weight matrix for the given method ("uniform",
    "inv_euclidean", or "half_cotangent")."""
    coo = _fem._weights_coo(points, triangles, method)
    if sparse:
        return coo
    return _fem.coo_to_dense(coo)


def laplace_operator(
    points: np.ndarray,
    triangles: np.ndarray,
    masses: Optional[np.ndarray] = None,
    weight_method: Literal[
        "uniform", "half_cotangent", "inv_euclidean"
    ] = "half_cotangent",
) -> np.ndarray:
    """The dense Laplace-Beltrami operator ``inv(M) @ L``."""
    return _fem.laplace_operator(
        points, triangles, masses=masses, weight_method=weight_method
    )


def gradient_triangles(
    points: np.ndarray,
    triangles: np.ndarray,
    areas: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense triangle gradient operators ``(Gx, Gy)`` of shape ``(m, n)``."""
    Gx, Gy = _fem.gradient_triangles_coo(points, triangles, areas=areas)
    return _fem.coo_to_dense(Gx), _fem.coo_to_dense(Gy)


def gradient_vertices(
    points: np.ndarray,
    triangles: np.ndarray,
    areas: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense vertex gradient operators ``(gx, gy)`` of shape ``(n, n)``."""
    gx, gy = _fem.gradient_vertices_coo(points, triangles, areas=areas)
    return _fem.coo_to_dense(gx), _fem.coo_to_dense(gy)

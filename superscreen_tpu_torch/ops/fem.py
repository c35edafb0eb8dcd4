"""Finite-element operators on triangular meshes.

Counterpart of ``superscreen_tpu/ops/fem.py``.  The operators are built on
the host with NumPy, in COO triplet form, exactly as the JAX package builds
them; :meth:`COO.to_dense`, :meth:`COO.to_gather` and :meth:`COO.matvec`
move them to torch tensors on the requested device.

Sparse products run in fixed-fan-in gather form (:func:`gather_form`,
:func:`gather_matvec`): every output row reads its own entries and sums
them in one fixed order, so a product gives the same bits on every run.
A scatter-add of the triplets (``index_add_``) uses atomics on a CUDA
device, whose order of additions changes from run to run.
"""

from dataclasses import dataclass
from typing import Literal, Optional, Tuple, Union

import numpy as np
import torch


__all__ = [
    "COO",
    "entry_table",
    "gather_form",
    "gather_matvec",
    "gather_matvec_batch",
    "coo_to_dense",
    "triangle_areas",
    "vertex_areas",
    "centroids",
    "adjacency_matrix",
    "in_polygon",
    "laplace_operator",
    "build_laplacian_coo",
    "gradient_triangles_coo",
    "gradient_vertices_coo",
]


def entry_table(keys: np.ndarray, n: int) -> np.ndarray:
    """For each key value ``0..n-1``, the positions ``k`` of the entries
    with ``keys[k]`` equal to it, in their order, as an ``(n, d)`` table
    (``d`` the largest count, at least 1) padded with ``len(keys)``: the
    fixed fan-in layout of a gather over a COO operator's rows (or, with
    its columns as keys, over its transpose's rows)."""
    keys = np.asarray(keys, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n)
    d = max(int(counts.max()) if len(counts) else 0, 1)
    table = np.full((n, d), len(keys), dtype=np.int64)
    starts = np.cumsum(counts) - counts
    table[keys[order], np.arange(len(keys)) - np.repeat(starts, counts)] = order
    return table


def gather_form(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int, dtype, torch_device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Converts COO triplets to fixed-fan-in gather form: ``(n_rows, d)``
    column indices and weights (``d`` the largest number of entries in a
    row), zero-weight padded.  Entries keep their triplet order within a
    row; duplicates stay separate entries and are summed by the product."""
    table = entry_table(rows, n_rows)
    idx = np.append(np.asarray(cols, dtype=np.int64), 0)[table]
    w = np.append(np.asarray(vals, dtype=dtype), np.zeros(1, dtype=dtype))[table]
    return (
        torch.as_tensor(idx, device=torch_device),
        torch.as_tensor(w, device=torch_device),
    )


def gather_matvec(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sparse product in gather form: ``(n_out, d)`` indices and weights
    applied to ``x`` of shape ``(n,)`` or ``(n, k)`` (columns)."""
    if x.ndim == 1:
        return torch.sum(w * x[idx], dim=1)
    return torch.sum(w[:, :, None] * x[idx], dim=1)


def gather_matvec_batch(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Batched sparse product in gather form: ``(n_out, d)`` indices and
    weights applied to ``g`` of shape ``(B, n)`` (rows)."""
    return torch.sum(w[None, :, :] * g[:, idx], dim=-1)


@dataclass(frozen=True)
class COO:
    """A sparse matrix in coordinate (triplet) format, held in NumPy.

    Duplicate ``(row, col)`` entries are implicitly summed (as in
    ``scipy.sparse``) by :meth:`matvec` and :meth:`to_dense`.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]

    def to_gather(self, dtype, torch_device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The operator in gather form on ``torch_device`` (see
        :func:`gather_form`); ``dtype`` is a NumPy float dtype."""
        return gather_form(self.rows, self.cols, self.vals, self.shape[0], dtype, torch_device)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` for a tensor ``x`` of shape ``(n,)`` or ``(n, k)``, on
        ``x``'s device, in gather form (reproducible to the bit)."""
        np_dtype = torch.empty((), dtype=x.dtype).numpy().dtype
        return gather_matvec(*self.to_gather(np_dtype, x.device), x)

    def to_dense(self, dtype, torch_device) -> torch.Tensor:
        """The dense ``(rows, cols)`` tensor, assembled on ``torch_device``
        from the triplets (only the triplets cross to the device)."""
        out = torch.zeros(self.shape, dtype=dtype, device=torch_device)
        index = (
            torch.as_tensor(self.rows, device=torch_device),
            torch.as_tensor(self.cols, device=torch_device),
        )
        vals = torch.as_tensor(self.vals, dtype=dtype, device=torch_device)
        return out.index_put_(index, vals, accumulate=True)

    def coalesce(self) -> "COO":
        """Sums duplicate entries, producing unique (row, col) triplets."""
        n_cols = self.shape[1]
        keys = self.rows.astype(np.int64) * n_cols + self.cols.astype(np.int64)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        vals = self.vals[order]
        unique_keys, starts = np.unique(keys, return_index=True)
        sums = np.add.reduceat(vals, starts)
        return COO(
            rows=(unique_keys // n_cols).astype(np.int64),
            cols=(unique_keys % n_cols).astype(np.int64),
            vals=sums,
            shape=self.shape,
        )

    @property
    def T(self) -> "COO":
        """The transpose."""
        return COO(self.cols, self.rows, self.vals, (self.shape[1], self.shape[0]))


def triangle_areas(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Signed areas of each triangle (positive for CCW vertex order)."""
    xy = points[triangles]
    s = xy[:, [2, 0]] - xy[:, [1, 2]]
    return 0.5 * np.linalg.det(s)


def vertex_areas(
    points: np.ndarray,
    triangles: np.ndarray,
    tri_areas: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Effective vertex areas: one third of the summed adjacent triangle
    areas (the lumped FEM mass matrix diagonal)."""
    if tri_areas is None:
        tri_areas = triangle_areas(points, triangles)
    v_areas = np.zeros(len(points), dtype=float)
    third = np.broadcast_to((tri_areas / 3)[:, None], triangles.shape)
    np.add.at(v_areas, triangles, third)
    return v_areas


def coo_to_dense(coo: COO, dtype=None) -> np.ndarray:
    """The dense NumPy array of a COO matrix (duplicates summed), in
    ``dtype`` (default: the values' dtype)."""
    out = np.zeros(coo.shape, dtype=dtype or coo.vals.dtype)
    np.add.at(out, (coo.rows, coo.cols), coo.vals.astype(out.dtype))
    return out


def centroids(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Triangle centroid coordinates."""
    return np.asarray(points)[np.asarray(triangles)].mean(axis=1)


def adjacency_matrix(triangles: np.ndarray, sparse: bool = False) -> Union[np.ndarray, COO]:
    """Vertex adjacency matrix of the triangulation (dense NumPy by default,
    a :class:`COO` when ``sparse``)."""
    triangles = np.asarray(triangles)
    edges = np.concatenate([triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]])
    n = int(triangles.max()) + 1
    adj = np.zeros((n, n), dtype=int)
    adj[edges[:, 0], edges[:, 1]] = 1
    adj[edges[:, 1], edges[:, 0]] = 1
    if sparse:
        rows, cols = np.nonzero(adj)
        return COO(rows, cols, np.ones(len(rows)), (n, n))
    return adj


def in_polygon(
    poly_points: np.ndarray, query_points: np.ndarray, radius: float = 0
) -> Union[bool, np.ndarray]:
    """Which ``query_points`` lie inside the polygon, as matplotlib's
    ``Path(poly_points).contains_points(query_points, radius=radius)``
    decides it (see :func:`superscreen_tpu_torch.device.polygon.points_in_ring`;
    a nonzero ``radius`` moves every edge by ``radius / 2`` to its right,
    :func:`superscreen_tpu_torch.device.polygon.offset_ring`)."""
    from ..device.polygon import offset_ring, points_in_ring

    ring = np.atleast_2d(np.asarray(poly_points, dtype=float))
    if not np.array_equal(ring[0], ring[-1]):
        ring = np.concatenate([ring, ring[:1]], axis=0)
    if radius != 0:
        ring = offset_ring(ring, radius / 2)
    bool_array = np.squeeze(points_in_ring(ring, query_points))
    if bool_array.ndim == 0:
        bool_array = bool_array.item()
    return bool_array


def _triangle_angles(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Interior angle of each triangle at each of its three vertices,
    shape ``(m, 3)``."""
    p = points[triangles]  # (m, 3, 2)
    angles = np.zeros((len(triangles), 3))
    for k in range(3):
        v1 = p[:, (k + 1) % 3] - p[:, k]
        v2 = p[:, (k + 2) % 3] - p[:, k]
        cosang = np.sum(v1 * v2, axis=1) / (
            np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1)
        )
        angles[:, k] = np.arccos(np.clip(cosang, -1.0, 1.0))
    return angles


def _weights_coo(
    points: np.ndarray,
    triangles: np.ndarray,
    method: str,
) -> COO:
    """Symmetric edge-weight matrix in COO form.

    Methods:
        * ``half_cotangent``: ``w_ij = 0.5 * (cot(alpha) + cot(beta))`` where
          alpha/beta are the angles opposite edge ``(i, j)``.
        * ``inv_euclidean``: ``w_ij = 1 / |r_i - r_j|``.
        * ``uniform``: adjacency.
    """
    points = np.asarray(points, dtype=float)
    triangles = np.asarray(triangles)
    n = len(points)
    method = method.lower()
    if method == "half_cotangent":
        angles = _triangle_angles(points, triangles)
        rows, cols, vals = [], [], []
        for k in range(3):
            i = triangles[:, (k + 1) % 3]
            j = triangles[:, (k + 2) % 3]
            w = 0.5 / np.tan(angles[:, k])
            rows.extend([i, j])
            cols.extend([j, i])
            vals.extend([w, w])
        return COO(
            np.concatenate(rows),
            np.concatenate(cols),
            np.concatenate(vals),
            (n, n),
        ).coalesce()
    if method in ("inv_euclidean", "uniform"):
        # Assignment semantics (not summed): deduplicate edges first.
        edges = np.concatenate(
            [triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]]
        )
        edges = np.unique(np.sort(edges, axis=1), axis=0)
        if method == "uniform":
            w = np.ones(len(edges))
        else:
            w = 1.0 / np.linalg.norm(
                points[edges[:, 0]] - points[edges[:, 1]], axis=1
            )
        return COO(
            np.concatenate([edges[:, 0], edges[:, 1]]),
            np.concatenate([edges[:, 1], edges[:, 0]]),
            np.concatenate([w, w]),
            (n, n),
        )
    raise ValueError(
        f"Unknown method ({method}). Supported methods are 'uniform', "
        f"'inv_euclidean', and 'half_cotangent'."
    )


def build_laplacian_coo(
    points: np.ndarray,
    triangles: np.ndarray,
    masses: Optional[np.ndarray] = None,
    weight_method: Literal[
        "uniform", "half_cotangent", "inv_euclidean"
    ] = "half_cotangent",
) -> COO:
    """Laplace-Beltrami operator ``inv(M) @ L`` in COO form."""
    points = np.asarray(points, dtype=float)
    triangles = np.asarray(triangles)
    n = len(points)
    if masses is None:
        masses = vertex_areas(points, triangles)
    W = _weights_coo(points, triangles, weight_method).coalesce()
    # Zero any diagonal then set diag = -row sums.
    off = W.rows != W.cols
    rows, cols, vals = W.rows[off], W.cols[off], W.vals[off]
    row_sums = np.zeros(n)
    np.add.at(row_sums, rows, vals)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, -row_sums])
    inv_mass = 1.0 / np.asarray(masses)
    vals = vals * inv_mass[rows]
    return COO(rows, cols, vals, (n, n))


def laplace_operator(
    points: np.ndarray,
    triangles: np.ndarray,
    masses: Optional[np.ndarray] = None,
    weight_method: Literal["uniform", "half_cotangent", "inv_euclidean"] = "half_cotangent",
) -> np.ndarray:
    """The dense Laplace-Beltrami operator ``inv(M) @ L`` (NumPy)."""
    return coo_to_dense(
        build_laplacian_coo(points, triangles, masses=masses, weight_method=weight_method)
    )


def gradient_triangles_coo(
    points: np.ndarray,
    triangles: np.ndarray,
    areas: Optional[np.ndarray] = None,
) -> Tuple[COO, COO]:
    """Triangle gradient operators ``Gx, Gy`` of shape ``(m, n)`` such that
    ``Gx @ f`` is the x-gradient of a vertex field evaluated at triangle
    centroids."""
    points = np.asarray(points, dtype=float)
    triangles = np.asarray(triangles)
    if areas is None:
        areas = triangle_areas(points, triangles)
    xy = points[triangles]  # (m, 3, 2)
    edges = np.roll(xy, 2, axis=1) - np.roll(xy, 1, axis=1)
    # Rotate edges clockwise by 90 degrees: (x, y) -> (y, -x).
    vals_x = +edges[:, :, 1] / (2 * areas[:, None])
    vals_y = -edges[:, :, 0] / (2 * areas[:, None])
    m, n = len(triangles), len(points)
    rows = np.repeat(np.arange(m), 3)
    cols = triangles.ravel()
    Gx = COO(rows, cols, vals_x.ravel(), (m, n))
    Gy = COO(rows, cols, vals_y.ravel(), (m, n))
    return Gx, Gy


def gradient_vertices_coo(
    points: np.ndarray,
    triangles: np.ndarray,
    areas: Optional[np.ndarray] = None,
    weighting: str = "first_vertex",
) -> Tuple[COO, COO]:
    """Vertex gradient operators ``gx, gy`` of shape ``(n, n)``: the
    gradient at a vertex is the average of the gradients of its adjacent
    triangles, angle-weighted.

    ``weighting`` selects each adjacent triangle's angle: ``"first_vertex"``
    (default) its interior angle at its first vertex, as the reference
    does; ``"shared_vertex"`` its angle at the shared vertex."""
    points = np.asarray(points, dtype=float)
    triangles = np.asarray(triangles)
    n = len(points)
    if areas is None:
        areas = triangle_areas(points, triangles)
    Gx, Gy = gradient_triangles_coo(points, triangles, areas=areas)
    angles = _triangle_angles(points, triangles)  # (m, 3)
    if weighting == "first_vertex":
        # One weight per triangle (its angle at local vertex 0), applied to
        # every vertex of that triangle.
        tri_w = np.repeat(angles[:, :1], 3, axis=1)
    elif weighting == "shared_vertex":
        tri_w = angles
    else:
        raise ValueError(
            f"weighting must be 'first_vertex' or 'shared_vertex', got {weighting!r}."
        )
    W = np.zeros(n)
    np.add.at(W, triangles, tri_w)
    # For each (triangle t, local vertex k of t, local vertex l of t):
    # gx[triangles[t, k], triangles[t, l]] += tri_w[t, k]/W * Gx_vals[t, l]
    m = len(triangles)
    Gx_vals = Gx.vals.reshape(m, 3)
    Gy_vals = Gy.vals.reshape(m, 3)
    rows, cols, vx, vy = [], [], [], []
    for k in range(3):
        i = triangles[:, k]
        w = tri_w[:, k] / W[i]
        for loc in range(3):
            j = triangles[:, loc]
            rows.append(i)
            cols.append(j)
            vx.append(w * Gx_vals[:, loc])
            vy.append(w * Gy_vals[:, loc])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    gx = COO(rows, cols, np.concatenate(vx), (n, n)).coalesce()
    gy = COO(rows, cols, np.concatenate(vy), (n, n)).coalesce()
    return gx, gy

"""Interpolation on triangular meshes, on a torch device.

Counterpart of ``superscreen_tpu/ops/interp.py``:

* :class:`TriangleIndex`: a uniform-grid spatial index over the
  triangulation, built once on the host (NumPy) and stored as tensors on a
  torch device.
* :func:`locate`: point location.  Candidate triangles come from the grid
  cell; the containing triangle is the candidate with the largest minimum
  barycentric coordinate (robust to points on edges and vertices).
* :func:`interp_linear` / :func:`interp_cubic`: barycentric interpolation
  of per-vertex scalar or vector data.  The cubic variant evaluates a
  Bezier triangle built from vertex values and vertex gradients (supplied
  by the mesh's vertex-gradient operator).

The index, the point location and the barycentric weights are float64
whatever the dtype of the data: in float32 a film of 15 length units with
edges of 0.05 carries ~4e-5 of error in a barycentric coordinate, more
than the tolerance that accepts a query on a shared edge, and such a
query would come back as outside the mesh.  The interpolated values are
cast to the dtype of the data at the end.  Queries run in chunks of
:data:`QUERY_CHUNK` points; no batch is padded.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["TriangleIndex", "build_triangle_index", "locate", "interp_linear", "interp_cubic"]

# Barycentric tolerance: slightly negative coordinates are accepted so points
# sitting exactly on shared edges/vertices are never reported as outside.
_BARY_EPS = 1e-6

#: Queries located at once: bounds the ``(chunk, K, 3, 2)`` candidate
#: corners held at a time.
QUERY_CHUNK = 65536


class TriangleIndex(NamedTuple):
    """Uniform-grid spatial index over a triangulation (float64 and int64
    tensors on one torch device)."""

    tri_verts: torch.Tensor  # (m, 3, 2) triangle vertex coordinates
    elements: torch.Tensor  # (m, 3) triangle -> site indices
    cell_tris: torch.Tensor  # (n_cells, K) candidate triangles per cell, -1 padded
    origin: torch.Tensor  # (2,) grid lower-left corner
    inv_step: torch.Tensor  # (2,) reciprocal cell size
    grid_dims: Tuple[int, int]  # (ncx, ncy)


def build_triangle_index(
    sites: np.ndarray, elements: np.ndarray, torch_device="cpu"
) -> TriangleIndex:
    """Build the spatial index on the host and store it on ``torch_device``.

    The grid resolution targets ~1 triangle per cell; each cell stores every
    triangle whose bounding box overlaps it (in ascending order), padded to
    the maximum count K.
    """
    sites = np.asarray(sites, dtype=float)
    elements = np.asarray(elements, dtype=np.int64)
    tri_pts = sites[elements]  # (m, 3, 2)
    m = len(elements)
    lo = sites.min(axis=0)
    hi = sites.max(axis=0)
    span = np.maximum(hi - lo, 1e-30)
    # ncx * ncy ~= m, cells roughly square.
    ncx = max(1, int(round(np.sqrt(m * span[0] / span[1]))))
    ncy = max(1, int(round(np.sqrt(m * span[1] / span[0]))))
    step = span / (ncx, ncy)
    inv_step = 1.0 / step

    tri_lo = np.clip(((tri_pts.min(axis=1) - lo) * inv_step).astype(int), 0, (ncx - 1, ncy - 1))
    tri_hi = np.clip(((tri_pts.max(axis=1) - lo) * inv_step).astype(int), 0, (ncx - 1, ncy - 1))
    # One (cell, triangle) entry per cell of each triangle's bounding box.
    extent = tri_hi - tri_lo + 1  # (m, 2)
    per_tri = extent[:, 0] * extent[:, 1]
    tri_of = np.repeat(np.arange(m), per_tri)
    local = np.arange(per_tri.sum()) - np.repeat(np.cumsum(per_tri) - per_tri, per_tri)
    cx = tri_lo[tri_of, 0] + local // extent[tri_of, 1]
    cy = tri_lo[tri_of, 1] + local % extent[tri_of, 1]
    cell_of = cx * ncy + cy
    # Stable sort by cell keeps each cell's triangles in ascending order.
    order = np.argsort(cell_of, kind="stable")
    cell_s, tri_s = cell_of[order], tri_of[order]
    counts = np.bincount(cell_s, minlength=ncx * ncy)
    K = max(1, int(counts.max()))
    cell_tris = np.full((ncx * ncy, K), -1, dtype=np.int64)
    slot = np.arange(len(cell_s)) - np.repeat(np.cumsum(counts) - counts, counts)
    cell_tris[cell_s, slot] = tri_s

    def on_device(array):
        return torch.as_tensor(array, device=torch_device)

    return TriangleIndex(
        tri_verts=on_device(tri_pts),
        elements=on_device(elements),
        cell_tris=on_device(cell_tris),
        origin=on_device(lo),
        inv_step=on_device(inv_step),
        grid_dims=(ncx, ncy),
    )


def _locate_chunk(index: TriangleIndex, pts: torch.Tensor):
    ncx, ncy = index.grid_dims
    cell = torch.floor((pts - index.origin) * index.inv_step).to(torch.int64)
    cx = torch.clamp(cell[:, 0], 0, ncx - 1)
    cy = torch.clamp(cell[:, 1], 0, ncy - 1)
    candidates = index.cell_tris[cx * ncy + cy]  # (k, K)
    safe = torch.clamp(candidates, min=0)
    corners = index.tri_verts[safe]  # (k, K, 3, 2)
    a, b, c = corners[:, :, 0], corners[:, :, 1], corners[:, :, 2]
    ab = b - a
    ac = c - a
    ap = pts[:, None, :] - a
    det = ab[..., 0] * ac[..., 1] - ab[..., 1] * ac[..., 0]
    nonzero = det != 0
    inv_det = torch.where(nonzero, 1.0 / torch.where(nonzero, det, torch.ones_like(det)), 0.0)
    wb = (ap[..., 0] * ac[..., 1] - ap[..., 1] * ac[..., 0]) * inv_det
    wc = (ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]) * inv_det
    bary = torch.stack([1.0 - wb - wc, wb, wc], dim=-1)  # (k, K, 3)
    score = torch.where(
        (candidates >= 0) & nonzero,
        bary.min(dim=-1).values,
        torch.full_like(det, -torch.inf),
    )  # (k, K)
    best = torch.argmax(score, dim=1)
    k_idx = torch.arange(pts.shape[0], device=pts.device)
    found = score[k_idx, best] >= -_BARY_EPS
    return safe[k_idx, best], bary[k_idx, best], found


def locate(index: TriangleIndex, points: torch.Tensor):
    """Find the containing triangle and barycentric coordinates per point.

    ``points`` is a ``(k, 2)`` float64 tensor on the index's device.
    Returns ``(tri, bary, found)`` with shapes ``(k,)``, ``(k, 3)``,
    ``(k,)``; ``tri`` is a valid index even where ``found`` is False.  On an
    edge shared by two triangles either may be returned: both interpolants
    are continuous across it.
    """
    pts = torch.atleast_2d(points)
    if pts.dtype != torch.float64 or pts.device != index.tri_verts.device:
        raise ValueError(
            f"locate needs float64 points on {index.tri_verts.device}, got {pts.dtype} "
            f"on {pts.device}."
        )
    parts = [
        _locate_chunk(index, pts[lo : lo + QUERY_CHUNK])
        for lo in range(0, max(pts.shape[0], 1), QUERY_CHUNK)
    ]
    return tuple(torch.cat(column) for column in zip(*parts))


def _query_tensor(index: TriangleIndex, points) -> torch.Tensor:
    pts = np.atleast_2d(np.asarray(points, dtype=float))
    return torch.as_tensor(pts, device=index.tri_verts.device)


def _data_tensor(index: TriangleIndex, values):
    """``values`` as a float64 tensor on the index's device, and the dtype
    results are cast to at the end (that of floating data, else float64)."""
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values))
    out_dtype = values.dtype if values.is_floating_point() else torch.float64
    return values.to(device=index.tri_verts.device, dtype=torch.float64), out_dtype


def interp_linear(index: TriangleIndex, values, points, fill=np.nan) -> torch.Tensor:
    """Barycentric-linear interpolation of per-vertex data at ``points``.

    ``values`` may be ``(n,)`` or ``(n, d)`` (NumPy or tensor); points
    outside the mesh get ``fill``.  Returns a tensor of shape ``(k,)`` /
    ``(k, d)`` on the index's device, in the dtype of ``values``.
    """
    vals, out_dtype = _data_tensor(index, values)
    tri, bary, found = locate(index, _query_tensor(index, points))
    corner_vals = vals[index.elements[tri]]  # (k, 3) or (k, 3, d)
    weights = bary if corner_vals.ndim == 2 else bary[..., None]
    out = (weights * corner_vals).sum(dim=1)
    mask = found if out.ndim == 1 else found[:, None]
    return torch.where(mask, out, torch.full_like(out, float(fill))).to(out_dtype)


def interp_cubic(index: TriangleIndex, values, gradients, points, fill=np.nan) -> torch.Tensor:
    """C1-style cubic interpolation of scalar per-vertex data.

    ``gradients`` is the ``(n, 2)`` per-vertex gradient of ``values``
    (typically from the mesh's vertex-gradient operator).  Returns a ``(k,)``
    tensor on the index's device, in the dtype of ``values``.
    """
    vals, out_dtype = _data_tensor(index, values)
    grads, _ = _data_tensor(index, gradients)
    tri, bary, found = locate(index, _query_tensor(index, points))
    idx = index.elements[tri]  # (k, 3)
    f = vals[idx]  # (k, 3)
    g = grads[idx]  # (k, 3, 2)
    corners = index.tri_verts[tri]  # (k, 3, 2)

    # Bezier-triangle control net from vertex values + gradients: the two
    # control points adjacent to each corner lie one third of the way along
    # each edge in the direction of the corner's gradient.
    def edge_ctrl(i, j):
        return f[:, i] + ((corners[:, j] - corners[:, i]) * g[:, i]).sum(-1) / 3.0

    b210, b201 = edge_ctrl(0, 1), edge_ctrl(0, 2)
    b120, b021 = edge_ctrl(1, 0), edge_ctrl(1, 2)
    b102, b012 = edge_ctrl(2, 0), edge_ctrl(2, 1)
    edge_mean = (b210 + b201 + b120 + b021 + b102 + b012) / 6.0
    vertex_mean = f.mean(dim=1)
    b111 = edge_mean + (edge_mean - vertex_mean) / 2.0

    u, v, w = bary[:, 0], bary[:, 1], bary[:, 2]
    out = (
        u**3 * f[:, 0]
        + v**3 * f[:, 1]
        + w**3 * f[:, 2]
        + 3 * u**2 * (v * b210 + w * b201)
        + 3 * v**2 * (u * b120 + w * b021)
        + 3 * w**2 * (u * b102 + v * b012)
        + 6 * u * v * w * b111
    )
    return torch.where(found, out, torch.full_like(out, float(fill))).to(out_dtype)

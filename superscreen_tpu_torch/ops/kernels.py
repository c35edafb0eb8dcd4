"""Pairwise kernels: the Brandt kernel ``Q`` (dense, or applied
matrix-free), inter-film Biot-Savart coupling, and the field and vector
potential of a sheet current anywhere in space; and the mixed-precision
residual of a float32 film system (:func:`residual_f64`).

Counterpart of ``superscreen_tpu/ops/kernels.py``.  Each public function
dispatches on the device of its input tensors: a CPU tensor takes the
plain PyTorch version defined here (blocked over rows), a CUDA tensor
launches the hand-written kernel of :mod:`.cuda_kernels`, and any other
device raises.  There is no fallback from one to the other.
:func:`biot_savart_2d_field` and :func:`vector_potential_2d` have no kernel
of their own (the JAX package computes them outside any Pallas kernel):
the z-component of the field at points of one height is the
``biot_savart_batch`` sum and takes that route; the vector field, mixed
heights and the vector potential are blocked plain PyTorch on the tensors'
device.
"""

import os
from typing import Optional

import numpy as np
import torch

from . import cuda_kernels

__all__ = [
    "cdist",
    "q_matrix",
    "q_matrix_rect",
    "q_apply_rect",
    "q_apply",
    "C_vector",
    "Q_matrix",
    "Q_apply",
    "biot_savart_film_to_film_dz2",
    "biot_savart_film_to_film",
    "biot_savart_2d_field",
    "vector_potential_2d",
    "biot_savart_pair_dz2",
    "biot_savart_within_film",
    "boundary_effective_field",
    "residual_f64",
]

_ONE_OVER_4PI = 1 / (4 * np.pi)

# Row-block size of the plain O(n * m) versions.
_BLOCK = 2048


def _uses_kernel(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor
    (hand-written kernel); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"Unsupported tensor device {t.device} (expected cpu or cuda).")


def cdist(XA: torch.Tensor, XB: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """Pairwise distances between two point sets (2D or 3D), on their
    device (plain PyTorch: no kernel of its own)."""
    if metric not in ("euclidean", "sqeuclidean"):
        raise ValueError(
            f"Metric must be one of ('euclidean', 'sqeuclidean'), got {metric!r}."
        )
    d2 = torch.sum((XA[:, None, :] - XB[None, :, :]) ** 2, dim=-1)
    return d2 if metric == "sqeuclidean" else torch.sqrt(d2)


def _q_block(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``q(rows, src) = 1/(4 pi |r_i - r_j|^3)``, zero where the points
    coincide."""
    d2 = torch.sum((rows[:, None, :] - src[None, :, :]) ** 2, dim=-1)
    positive = d2 > 0
    r = torch.rsqrt(torch.where(positive, d2, torch.ones_like(d2)))
    return torch.where(positive, _ONE_OVER_4PI * (r * r * r), torch.zeros_like(d2))


def q_matrix_plain(points: torch.Tensor, block: int = _BLOCK) -> torch.Tensor:
    """Plain PyTorch ``q_ij = 1/(4 pi |r_i - r_j|^3)`` with zero diagonal
    (and zero at coincident points), computed in row blocks."""
    n = points.shape[0]
    out = torch.empty((n, n), dtype=points.dtype, device=points.device)
    for lo in range(0, n, block):
        out[lo : lo + block] = _q_block(points[lo : lo + block], points)
    return out


def q_matrix(points: torch.Tensor) -> torch.Tensor:
    """The matrix ``q_ij = 1 / (4 pi |r_i - r_j|^3)`` with zero diagonal.

    Args:
        points: ``(n, 2)`` mesh sites (float32 or float64).

    Returns:
        The ``(n, n)`` matrix on ``points``' device.
    """
    if _uses_kernel(points):
        return cuda_kernels.q_matrix(points.contiguous())
    return q_matrix_plain(points)


def q_matrix_rect_plain(
    eval_sites: torch.Tensor, src_sites: torch.Tensor, block: int = _BLOCK
) -> torch.Tensor:
    """Plain PyTorch ``q(eval_sites, src_sites)`` in row blocks: zero where
    a pair coincides, so each row equals that row of
    :func:`q_matrix_plain` on the same points, to the bit."""
    out = torch.empty(
        (eval_sites.shape[0], src_sites.shape[0]), dtype=src_sites.dtype, device=src_sites.device
    )
    for lo in range(0, eval_sites.shape[0], block):
        out[lo : lo + block] = _q_block(eval_sites[lo : lo + block], src_sites)
    return out


def q_matrix_rect(eval_sites: torch.Tensor, src_sites: torch.Tensor) -> torch.Tensor:
    """The rectangular block ``q(eval_sites, src_sites)`` ``(m, n)`` of the
    kernel matrix, zero where a pair coincides: ``q_matrix_rect(points[r0:
    r1], points)`` is rows ``r0:r1`` of :func:`q_matrix` with the diagonal,
    at column ``r0 + i`` of row ``i``, left zero for the caller.  A model
    slot of a row-sharded system assembles its rows with it."""
    if _uses_kernel(eval_sites):
        return cuda_kernels.q_matrix_rect(eval_sites.contiguous(), src_sites.contiguous())
    return q_matrix_rect_plain(eval_sites, src_sites)


def q_apply_plain(
    eval_sites: torch.Tensor, src_sites: torch.Tensor, V: torch.Tensor, block: int = _BLOCK
) -> torch.Tensor:
    """Plain PyTorch ``q(eval_sites, src_sites) @ V`` for ``V`` of shape
    ``(n, k)``, in blocks of evaluation rows (``O(block * n)`` memory)."""
    out = torch.empty((eval_sites.shape[0], V.shape[1]), dtype=V.dtype, device=V.device)
    for lo in range(0, eval_sites.shape[0], block):
        out[lo : lo + block] = _q_block(eval_sites[lo : lo + block], src_sites) @ V
    return out


def q_apply_rect(
    eval_sites: torch.Tensor, src_sites: torch.Tensor, vecs: torch.Tensor
) -> torch.Tensor:
    """Matrix-free rectangular ``q @ vecs``: rows are ``eval_sites``
    (``(m, 2)``), columns ``src_sites`` (``(n, 2)``); coincident points
    contribute zero, as on the square kernel's diagonal.  ``q`` is never
    stored.

    Args:
        eval_sites: ``(m, 2)`` evaluation points.
        src_sites: ``(n, 2)`` source points.
        vecs: ``(n,)`` or ``(n, k)``.

    Returns:
        ``(m,)`` or ``(m, k)``, matching ``vecs``.
    """
    squeeze = vecs.ndim == 1
    V = vecs[:, None] if squeeze else vecs
    if _uses_kernel(eval_sites):
        out = cuda_kernels.q_apply(
            eval_sites.contiguous(), src_sites.contiguous(), V.contiguous()
        )
    else:
        out = q_apply_plain(eval_sites, src_sites, V)
    return out[:, 0] if squeeze else out


def q_apply(points: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``q @ vecs`` for the square kernel on ``points``: the
    backbone of the low-memory path, with ``O(n)`` memory instead of the
    ``(n, n)`` matrix."""
    return q_apply_rect(points, points, vecs)


def C_vector(points: torch.Tensor) -> torch.Tensor:
    """Brandt's boundary-regularization vector ``C_i`` (Eq. 12 of
    [Brandt-PRB-2005])."""
    x = points[:, 0] - torch.mean(points[:, 0])
    y = points[:, 1] - torch.mean(points[:, 1])
    a = (torch.max(x) - torch.min(x)) / 2
    b = (torch.max(y) - torch.min(y)) / 2
    C = torch.zeros_like(x)
    for p in (-1.0, 1.0):
        for q in (-1.0, 1.0):
            C = C + torch.sqrt((a - p * x) ** -2 + (b - q * y) ** -2)
    C = torch.where(torch.isfinite(C), C, torch.full_like(C, 1e30))
    return C * _ONE_OVER_4PI


def Q_matrix(points: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The Brandt kernel matrix ``Q`` (Eq. 10 of [Brandt-PRB-2005]):
    ``Q_ij = -q_ij`` off-diagonal and ``Q_ii = (C_i + sum_l q_il w_l) / w_i``.

    ``q`` is negated in place, so only one ``(n, n)`` buffer is allocated.
    """
    q = q_matrix(points)
    diag = (C_vector(points) + q @ weights) / weights
    Q = q.neg_()
    Q.diagonal().copy_(diag)
    return Q


def Q_apply(points: torch.Tensor, weights: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``Q @ vecs`` for the Brandt kernel
    ``Q_ij = -q_ij + delta_ij (C_i + sum_l q_il w_l) / w_i``, in one
    :func:`q_apply` launch: the row sums ``q @ w`` ride along as an extra
    column.

    Args:
        points: ``(n, 2)`` mesh sites.
        weights: ``(n,)`` vertex areas.
        vecs: ``(n,)`` or ``(n, k)``.

    Returns:
        ``Q @ vecs``, shaped like ``vecs``.
    """
    squeeze = vecs.ndim == 1
    V = vecs[:, None] if squeeze else vecs
    qV = q_apply(points, torch.cat([V, weights[:, None]], dim=1))
    diag = (C_vector(points) + qV[:, -1]) / weights
    out = diag[:, None] * V - qV[:, :-1]
    return out[:, 0] if squeeze else out


def biot_savart_plain(
    src_sites: torch.Tensor,
    src_areas: torch.Tensor,
    J: torch.Tensor,
    dst_sites: torch.Tensor,
    dz2: float,
    block: int = _BLOCK,
) -> torch.Tensor:
    """Plain PyTorch batched Biot-Savart field, ``J`` of shape
    ``(B, n1, 2)``; returns ``(B, n2)``.  Computed in blocks of evaluation
    rows, with each block's geometry contracted against all ``B`` columns
    as a matrix product."""
    aJx = (src_areas[None, :] * J[:, :, 0]).T  # (n1, B)
    aJy = (src_areas[None, :] * J[:, :, 1]).T
    n2 = dst_sites.shape[0]
    out = torch.empty((n2, J.shape[0]), dtype=J.dtype, device=J.device)
    for lo in range(0, n2, block):
        rows = dst_sites[lo : lo + block]
        dx = rows[:, 0:1] - src_sites[None, :, 0]
        dy = rows[:, 1:2] - src_sites[None, :, 1]
        r = torch.rsqrt(dx * dx + dy * dy + dz2)
        r3 = r * r * r
        out[lo : lo + block] = (dy * r3) @ aJx - (dx * r3) @ aJy
    return (_ONE_OVER_4PI * out).T.contiguous()


def biot_savart_film_to_film_dz2(
    film1_sites: torch.Tensor,
    film1_areas: torch.Tensor,
    film1_J: torch.Tensor,
    film2_sites: torch.Tensor,
    dz2: float,
) -> torch.Tensor:
    """Biot-Savart field at ``film2_sites`` from the sheet current
    ``film1_J`` at ``film1_sites``, with the squared layer separation
    ``dz2``, in ``current / length`` units.

    ``film1_J`` may be ``(n1, 2)`` (returns ``(n2,)``) or batched
    ``(B, n1, 2)`` (returns ``(B, n2)``).  Like the JAX package there is
    no ``r > 0`` guard.
    """
    squeeze = film1_J.ndim == 2
    J = film1_J[None] if squeeze else film1_J
    if _uses_kernel(J):
        out = cuda_kernels.biot_savart_batch(
            film1_sites.contiguous(),
            film1_areas.contiguous(),
            J.contiguous(),
            film2_sites.contiguous(),
            dz2,
        )
    else:
        out = biot_savart_plain(film1_sites, film1_areas, J, film2_sites, dz2)
    return out[0] if squeeze else out


def biot_savart_film_to_film(
    film1_sites: torch.Tensor,
    film1_z0: float,
    film1_areas: torch.Tensor,
    film1_J: torch.Tensor,
    film2_sites: torch.Tensor,
    film2_z0: float,
) -> torch.Tensor:
    """Biot-Savart field at ``film2_sites`` (z = film2_z0) from the sheet
    current ``film1_J`` flowing at ``film1_sites`` (z = film1_z0), in
    ``current / length`` units (see :func:`biot_savart_film_to_film_dz2`)."""
    return biot_savart_film_to_film_dz2(
        film1_sites, film1_areas, film1_J, film2_sites, float((film2_z0 - film1_z0) ** 2)
    )


def biot_savart_2d_field_plain(
    eval_positions: torch.Tensor,
    positions: torch.Tensor,
    current_densities: torch.Tensor,
    areas: torch.Tensor,
    vector: bool = True,
    block: int = _BLOCK,
) -> torch.Tensor:
    """Plain PyTorch field of a sheet current at 3D points (see
    :func:`biot_savart_2d_field`), in blocks of evaluation rows.  Pairs
    with ``r = 0`` contribute zero.  Each block's intermediates are freed
    before the next, so a large map holds ``O(block * m)`` values."""
    aJx = areas * current_densities[:, 0]
    aJy = areas * current_densities[:, 1]
    n = eval_positions.shape[0]
    out = torch.empty((n, 3 if vector else 1), dtype=aJx.dtype, device=aJx.device)
    for lo in range(0, n, block):
        P = eval_positions[lo : lo + block]
        dx = P[:, 0:1] - positions[None, :, 0]
        dy = P[:, 1:2] - positions[None, :, 1]
        dz = P[:, 2:3] - positions[None, :, 2]
        r2 = dx * dx + dy * dy + dz * dz
        positive = r2 > 0
        rinv = torch.rsqrt(torch.where(positive, r2, torch.ones_like(r2)))
        r3 = torch.where(positive, rinv * rinv * rinv, torch.zeros_like(r2))
        out[lo : lo + block, -1] = (dy * r3) @ aJx - (dx * r3) @ aJy
        if vector:
            zr3 = dz * r3
            out[lo : lo + block, 0] = zr3 @ aJy
            out[lo : lo + block, 1] = -(zr3 @ aJx)
            del zr3
        del dx, dy, dz, r2, positive, rinv, r3
    out *= _ONE_OVER_4PI
    return out if vector else out[:, 0]


def biot_savart_2d_field(
    eval_positions: torch.Tensor,
    positions: torch.Tensor,
    current_densities: torch.Tensor,
    areas: torch.Tensor,
    vector: bool = True,
) -> torch.Tensor:
    """Magnetic field ``H`` at 3D ``eval_positions`` from a sheet current,
    ``(1 / 4 pi) sum_j a_j J_j x (r - r_j) / |r - r_j|^3``, in
    ``current / length`` of the inputs' units.

    Unlike the JAX package's function of this name, which takes SI inputs
    and returns tesla, the sum is formed in the caller's units (in float32
    SI lengths put ``r^-3`` near 1e18 and areas near 1e-12) and
    :func:`superscreen_tpu_torch.sources.biot_savart_2d` applies the one
    scalar that makes it tesla.

    With ``vector=False``, all evaluation points at one height and the
    sheet at one height, this is the ``biot_savart_batch`` sum with
    ``dz2 = (z - z0)^2`` and goes through
    :func:`biot_savart_film_to_film_dz2` (the kernel on a CUDA tensor, with
    ``O(n)`` memory).  That sum has no ``r = 0`` guard: with ``dz2 = 0`` an
    evaluation point may sit on a sheet position, so that case takes the
    plain version, as do mixed heights and ``vector=True``.

    Args:
        eval_positions: ``(n, 3)`` evaluation coordinates.
        positions: ``(m, 3)`` sheet coordinates.
        current_densities: ``(m, 2)`` sheet current density.
        areas: ``(m,)`` effective vertex areas.
        vector: If True returns ``(n, 3)`` (Hx, Hy, Hz); else ``(n,)`` Hz.
    """
    if not vector and eval_positions.shape[0] and positions.shape[0]:
        z, z0 = eval_positions[0, 2], positions[0, 2]
        one_height = bool(
            torch.all(eval_positions[:, 2] == z) & torch.all(positions[:, 2] == z0)
        )
        dz2 = float((z - z0) ** 2)
        if one_height and dz2 > 0:
            return biot_savart_film_to_film_dz2(
                positions[:, :2], areas, current_densities, eval_positions[:, :2], dz2
            )
    _uses_kernel(eval_positions)  # only to refuse a device that is neither cpu nor cuda
    return biot_savart_2d_field_plain(
        eval_positions, positions, current_densities, areas, vector=vector
    )


def vector_potential_2d(
    eval_positions: torch.Tensor,
    eval_zs: torch.Tensor,
    positions: torch.Tensor,
    z0: float,
    areas: torch.Tensor,
    J: torch.Tensor,
    block: int = _BLOCK,
) -> torch.Tensor:
    """In-plane vector potential (Ax, Ay) of a sheet current:
    ``A(r) = 1/(4 pi) int J(r') / |r - r'| d^2r'`` (without the mu_0
    prefactor; units ``current``).  Blocked plain PyTorch on the tensors'
    device.

    An evaluation point that coincides with a sheet position (a contour
    along a feature ring of the same film) would divide by zero; its self
    term is dropped, as ``q_matrix`` drops its diagonal (the ``1/r``
    singularity is integrable, so the term's continuum weight is zero).

    Args:
        eval_positions: ``(m, 2)`` evaluation coordinates.
        eval_zs: ``(m,)`` evaluation heights.
        positions: ``(n, 2)`` sheet coordinates.
        z0: Sheet height.
        areas: ``(n,)`` vertex areas.
        J: ``(n, 2)`` sheet current density.

    Returns:
        ``(m, 2)`` vector potential (times 4 pi / mu_0).
    """
    _uses_kernel(eval_positions)  # only to refuse a device that is neither cpu nor cuda
    m = eval_positions.shape[0]
    out = torch.empty((m, 2), dtype=J.dtype, device=J.device)
    for lo in range(0, m, block):
        P = eval_positions[lo : lo + block]
        dx = P[:, 0:1] - positions[None, :, 0]
        dy = P[:, 1:2] - positions[None, :, 1]
        dz = eval_zs[lo : lo + block, None] - z0
        r2 = dx * dx + dy * dy + dz * dz
        positive = r2 > 0
        rinv = torch.where(
            positive, torch.rsqrt(torch.where(positive, r2, torch.ones_like(r2))), torch.zeros_like(r2)
        )
        out[lo : lo + block] = (areas[None, :] * rinv) @ J
        del dx, dy, dz, r2, positive, rinv
    return _ONE_OVER_4PI * out


def biot_savart_pair_plain(
    sites1: torch.Tensor,
    areas1: torch.Tensor,
    J1: torch.Tensor,
    sites2: torch.Tensor,
    areas2: torch.Tensor,
    J2: torch.Tensor,
    dz2: float,
    block: int = _BLOCK,
):
    """Plain PyTorch twin of the ``biot_savart_pair`` kernel: both
    directions of a film pair from one geometry pass, ``J1`` ``(B, n1, 2)``
    and ``J2`` ``(B, n2, 2)``.  Each block of film-2 rows builds the
    geometry ``K = (dx, dy) r^-3`` once and contracts it with film 1's
    currents (field at film 2) and, transposed, with film 2's (field at
    film 1).  Returns ``((B, n2), (B, n1))``."""
    aJ1x = (areas1[None, :] * J1[:, :, 0]).T  # (n1, B)
    aJ1y = (areas1[None, :] * J1[:, :, 1]).T
    aJ2x = areas2[None, :] * J2[:, :, 0]  # (B, n2)
    aJ2y = areas2[None, :] * J2[:, :, 1]
    n2 = sites2.shape[0]
    out2 = torch.empty((n2, J1.shape[0]), dtype=J1.dtype, device=J1.device)
    out1 = torch.zeros((J2.shape[0], sites1.shape[0]), dtype=J2.dtype, device=J2.device)
    for lo in range(0, n2, block):
        rows = sites2[lo : lo + block]
        dx = rows[:, 0:1] - sites1[None, :, 0]
        dy = rows[:, 1:2] - sites1[None, :, 1]
        r = torch.rsqrt(dx * dx + dy * dy + dz2)
        r3 = r * r * r
        Kx, Ky = dx * r3, dy * r3
        out2[lo : lo + block] = Ky @ aJ1x - Kx @ aJ1y
        out1 += aJ2y[:, lo : lo + block] @ Kx - aJ2x[:, lo : lo + block] @ Ky
    return (_ONE_OVER_4PI * out2).T.contiguous(), _ONE_OVER_4PI * out1


def biot_savart_pair_dz2(
    film1_sites, film1_areas, film1_J, film2_sites, film2_areas, film2_J, dz2
):
    """Both directions of an inter-film coupling pair.  Returns
    ``(field_at_2_from_1, field_at_1_from_2)``, each ``(B, n)`` (or ``(n,)``
    for unbatched ``(n, 2)`` currents).

    With ``SUPERSCREEN_TPU_PAIR_COUPLING=1`` (read at call time) both
    directions come from one geometry pass (the ``biot_savart_pair``
    kernel, or its plain twin on the CPU); otherwise they are two one-way
    passes.  The JAX package also gates the fused path on the footprint of
    its reverse output in TPU VMEM; that is a TPU limit and has no
    counterpart here.
    """
    if os.environ.get("SUPERSCREEN_TPU_PAIR_COUPLING", "0") != "1":
        return (
            biot_savart_film_to_film_dz2(film1_sites, film1_areas, film1_J, film2_sites, dz2),
            biot_savart_film_to_film_dz2(film2_sites, film2_areas, film2_J, film1_sites, dz2),
        )
    squeeze = film1_J.ndim == 2
    J1, J2 = (film1_J[None], film2_J[None]) if squeeze else (film1_J, film2_J)
    args = (film1_sites, film1_areas, J1, film2_sites, film2_areas, J2)
    if _uses_kernel(J1):
        at2, at1 = cuda_kernels.biot_savart_pair(*(t.contiguous() for t in args), dz2)
    else:
        at2, at1 = biot_savart_pair_plain(*args, dz2)
    return (at2[0], at1[0]) if squeeze else (at2, at1)


def biot_savart_within_film(
    sites: torch.Tensor,
    tri_centroids: torch.Tensor,
    tri_areas: torch.Tensor,
    tri_J: torch.Tensor,
) -> torch.Tensor:
    """In-plane Biot-Savart self-field of a film from triangle-centroid
    current densities (the self-field of a film with transport terminals,
    whose stream is nonzero on its boundary).

    The same sum as :func:`biot_savart_film_to_film_dz2` with the triangle
    centroids as sources, the mesh sites as evaluation points and
    ``dz2 = 0``, so it takes that route: the ``biot_savart_batch`` kernel
    on the card, its plain version on the CPU.  The JAX package's version
    zeroes pairs at ``r = 0``; a centroid lies strictly inside its
    triangle, so no site of a valid mesh coincides with one.

    ``tri_J`` may be ``(m, 2)`` (returns ``(n,)``) or ``(B, m, 2)``
    (returns ``(B, n)``).
    """
    return biot_savart_film_to_film_dz2(tri_centroids, tri_areas, tri_J, sites, 0.0)


def boundary_effective_field(
    sites: torch.Tensor,
    boundary_centers: torch.Tensor,
    boundary_lengths: torch.Tensor,
    boundary_normals: torch.Tensor,
    boundary_stream: torch.Tensor,
    block: int = _BLOCK,
) -> torch.Tensor:
    """Effective field at the mesh ``sites`` ``(n, 2)`` from the
    transport-current boundary stream: a line of dipoles along the film
    edge, one per boundary segment (``(m, 2)`` centers and outward
    normals, ``(m,)`` lengths and mid-segment stream values).  Plain
    PyTorch on the tensors' device, in blocks of sites: ``n m`` terms, run
    a few times per factorized model."""
    out = torch.empty(sites.shape[0], dtype=sites.dtype, device=sites.device)
    weight = boundary_stream * boundary_lengths
    for lo in range(0, sites.shape[0], block):
        dr = sites[lo : lo + block, None, :] - boundary_centers[None, :, :]
        rinv = torch.rsqrt(torch.sum(dr * dr, dim=-1))
        dot = -torch.sum(dr * boundary_normals[None, :, :], dim=-1)
        out[lo : lo + block] = torch.sum(weight[None, :] * dot * (rinv * rinv * rinv), dim=1)
    return _ONE_OVER_4PI * out


def residual_f64_plain(
    A: torch.Tensor,
    X: torch.Tensor,
    H: Optional[torch.Tensor] = None,
    block: int = _BLOCK,
    *,
    out_dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """Plain PyTorch ``R = H + A @ X`` in float64 for a float32 ``A``
    ``(m, n)``, a float32 or float64 ``X`` ``(n, k)`` (widened once) and a
    float32 or float64 ``H`` ``(m, k)`` or ``None`` (zero): row blocks of
    ``A`` are widened on the fly (exactly) and multiplied in float64, so
    the transient is ``(block, n)``.  Returns ``out_dtype``: float64, or the
    float64 result rounded once (``.to``)."""
    X = X.double()
    R = torch.empty((A.shape[0], X.shape[1]), dtype=torch.float64, device=A.device)
    for lo in range(0, A.shape[0], block):
        rows = slice(lo, lo + block)
        if H is None:
            R[rows] = torch.mm(A[rows].double(), X)
        else:
            R[rows] = torch.addmm(H[rows].double(), A[rows].double(), X)
    return R if out_dtype == torch.float64 else R.to(out_dtype)


def residual_f64(
    A: torch.Tensor,
    X: torch.Tensor,
    H: Optional[torch.Tensor] = None,
    *,
    out_dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """The float64 residual ``R = H + A @ X`` of a system stored in
    float32: ``A`` ``(m, n)`` float32 (a film's square system, or the rows
    of a rectangular block), ``X`` ``(n, k)`` float32 or float64, ``H``
    ``(m, k)`` float32 or float64, or ``None`` for zero.  Every product and
    sum is float64, and widening ``A`` is exact, so this is the residual a
    float64 copy of ``A`` would give, at the cost of reading the float32
    one once.  The callers pass their tensors as they are: on the card the
    kernel reads either dtype, an ``X`` that is the transpose of a
    contiguous tensor, and rounds once to ``out_dtype``, so nothing is
    launched around it.

    Returns:
        ``(m, k)`` in ``out_dtype`` (float64 or float32), on the tensors'
        device.
    """
    if _uses_kernel(A):
        if not (X.is_contiguous() or X.mT.is_contiguous()):
            X = X.contiguous()
        return cuda_kernels.residual_f64(
            A.contiguous(), X, None if H is None else H.contiguous(), out_dtype=out_dtype
        )
    return residual_f64_plain(A, X, H, out_dtype=out_dtype)

"""Dense pairwise kernels: the Brandt kernel ``Q`` and inter-film
Biot-Savart coupling.

Counterpart of ``superscreen_tpu/ops/kernels.py``.  Each public function
dispatches on the device of its input tensors: a CPU tensor takes the
plain PyTorch version defined here (blocked over rows), a CUDA tensor
launches the hand-written kernel of :mod:`.cuda_kernels`, and any other
device raises.  There is no fallback from one to the other.
"""

import numpy as np
import torch

from . import cuda_kernels

__all__ = [
    "q_matrix",
    "C_vector",
    "Q_matrix",
    "biot_savart_film_to_film_dz2",
    "biot_savart_pair_dz2",
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


def q_matrix_plain(points: torch.Tensor, block: int = _BLOCK) -> torch.Tensor:
    """Plain PyTorch ``q_ij = 1/(4 pi |r_i - r_j|^3)`` with zero diagonal
    (and zero at coincident points), computed in row blocks."""
    n = points.shape[0]
    out = torch.empty((n, n), dtype=points.dtype, device=points.device)
    for lo in range(0, n, block):
        rows = points[lo : lo + block]
        d2 = torch.sum((rows[:, None, :] - points[None, :, :]) ** 2, dim=-1)
        positive = d2 > 0
        r = torch.rsqrt(torch.where(positive, d2, torch.ones_like(d2)))
        out[lo : lo + block] = torch.where(
            positive, _ONE_OVER_4PI * (r * r * r), torch.zeros_like(d2)
        )
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


def biot_savart_pair_dz2(
    film1_sites, film1_areas, film1_J, film2_sites, film2_areas, film2_J, dz2
):
    """Both directions of an inter-film coupling pair, as two one-way
    passes.  Returns ``(field_at_2_from_1, field_at_1_from_2)``."""
    return (
        biot_savart_film_to_film_dz2(film1_sites, film1_areas, film1_J, film2_sites, dz2),
        biot_savart_film_to_film_dz2(film2_sites, film2_areas, film2_J, film1_sites, dz2),
    )

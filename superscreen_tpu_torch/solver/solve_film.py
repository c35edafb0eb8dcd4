"""Per-film linear systems.

Counterpart of ``superscreen_tpu/solver/solve_film.py``: each film's system
``A = Q diag(w) - Lambda laplacian`` is restricted to the film's interior
(outside its holes) and LU-factorized on the torch device; each hole gets
the all-rows, hole-columns system whose row sums give the effective field
of a unit circulating current.

A film on the low-memory path (``FilmInfo.dense_kernel`` False) never
builds the full ``(n, n)`` kernel.  Its interior system is assembled from
the q-block of the interior sites, the matrix-free row sums ``q @ w`` and
the sparse Laplacian, and is LU-factorized; or, with
``SUPERSCREEN_TPU_LARGE_FACTOR=cg`` or an interior above the materialized
ceiling, it is not materialized at all and is solved by CG on the
matrix-free operator.  Its hole systems are the row-sum vectors
themselves.
"""

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import Device
from ..ops import kernels, linalg
from .utils import FilmInfo

__all__ = [
    "MAX_MATERIALIZED_BYTES",
    "LinearSystem",
    "factorize_linear_systems",
    "max_materialized_n",
]

#: Device bytes one low-memory film's factorization may take at its peak;
#: sets the default ceiling on the interior size ``ni`` of a film whose
#: system is materialized and LU-factorized (a larger interior is solved by
#: CG matrix-free).  At that peak the card holds ``A``, the transient
#: ``-A`` that :func:`ops.linalg.factor_system` hands to ``lu_factor`` and
#: the packed ``LU``: three ``(ni, ni)`` buffers, 12.0 bytes per ni^2 in
#: float32 as measured on an H100.  67.5 GB of an 80 GB card, which leaves
#: ~12 GB for the solver's workspace and the model's other tensors, gives
#: ni = 75,000 in float32 and 53,033 in float64.  The JAX package's
#: default, 65,000, was sized for a 16 GB TPU with another factorization.
#: ``SUPERSCREEN_TPU_MAX_MATERIALIZED_N`` (read when the model is
#: factorized) sets the ceiling directly.
MAX_MATERIALIZED_BYTES = 67_500_000_000


@dataclass
class LinearSystem:
    """The linear system for a film or hole.

    Args:
        A: The matrix ``Q diag(w) - Lambda laplacian`` restricted to
            ``indices`` (rows and columns for a film, columns for a hole).
            For a hole of a low-memory film, the vector ``A @ 1``.  None
            for a film solved matrix-free.
        indices: The mesh indices this system acts on.
        lu_piv: The LU factorization ``(LU, perm)`` of ``-A`` (see
            :func:`superscreen_tpu_torch.ops.linalg.factor_system`), or None.
        cg_op: The matrix-free operator pieces of a film solved by CG (see
            :func:`superscreen_tpu_torch.ops.linalg.brandt_matvec`), or None.
    """

    A: Optional[torch.Tensor]
    indices: np.ndarray
    lu_piv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    cg_op: Optional[Dict[str, torch.Tensor]] = None


def _build_system_1d(Q, weights, Lambda, laplacian, ix):
    """The 'effective applied field' system: all rows, columns ``ix``."""
    ix = torch.as_tensor(ix, device=Q.device)
    return Q[:, ix] * weights[ix] - Lambda[ix] * laplacian[:, ix]


def _build_system_2d(Q, weights, Lambda, laplacian, ix):
    """The stream-function system restricted to rows and columns ``ix``."""
    ix = torch.as_tensor(ix, device=Q.device)
    rows, cols = ix[:, None], ix[None, :]
    return Q[rows, cols] * weights[ix] - Lambda[ix] * laplacian[rows, cols]


def _restricted_lambda_triplets(info: FilmInfo, ix: np.ndarray, torch_device):
    """COO triplets, in the numbering of ``ix``, of the Laplacian
    restricted to ``ix`` with each column scaled by its Lambda, on
    ``torch_device``."""
    lap = info.laplacian
    Lambda = info.lambda_info.Lambda[:, 0]
    pos = np.full(lap.shape[0], -1, dtype=np.int64)
    pos[ix] = np.arange(len(ix))
    keep = (pos[lap.rows] >= 0) & (pos[lap.cols] >= 0)
    vals = (lap.vals[keep] * Lambda[lap.cols[keep]]).astype(info.sites.dtype)
    return (
        torch.as_tensor(pos[lap.rows[keep]], device=torch_device),
        torch.as_tensor(pos[lap.cols[keep]], device=torch_device),
        torch.as_tensor(vals, device=torch_device),
    )


def _lowmem_diag(info: FilmInfo, sites: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """The regularized Brandt diagonal ``(C_i + sum_l q_il w_l) / w_i`` at
    ``ix``, from the full site set, with the row sums ``q @ w`` applied
    matrix-free."""
    w = info.weights
    C = kernels.C_vector(sites)
    q_row_w = kernels.q_apply(sites, w)
    return (C[ix] + q_row_w[ix]) / w[ix]


def _build_system_2d_lowmem(info: FilmInfo, ix: np.ndarray, sites: torch.Tensor) -> torch.Tensor:
    """The interior system of a low-memory film without the full kernel:
    ``A = (-q(sub) + diag(d)) diag(w_sub) - scatter(Lambda_j L_ij)``.  The
    q-block of the interior sites is the only ``(ni, ni)`` buffer: it is
    turned into ``A`` in place."""
    ix_t = torch.as_tensor(ix, device=sites.device)
    diag = _lowmem_diag(info, sites, ix_t)
    A = kernels.q_matrix(sites[ix_t])
    A.neg_()
    A.diagonal().copy_(diag)
    A.mul_(info.weights[ix_t][None, :])
    rows, cols, vals = _restricted_lambda_triplets(info, ix, sites.device)
    return A.index_put_((rows, cols), -vals, accumulate=True)


def _lowmem_operator_pieces(info: FilmInfo, ix: np.ndarray, sites: torch.Tensor):
    """The matrix-free operator pieces of a low-memory film's interior
    system (see :func:`ops.linalg.brandt_matvec`); nothing of size
    ``(ni, ni)`` is built."""
    ix_t = torch.as_tensor(ix, device=sites.device)
    rows, cols, vals = _restricted_lambda_triplets(info, ix, sites.device)
    return {
        "sub_sites": sites[ix_t].contiguous(),
        "w_sub": info.weights[ix_t],
        "diag": _lowmem_diag(info, sites, ix_t),
        "lap_rows": rows,
        "lap_cols": cols,
        "lap_vals": vals,
    }


def _hole_effective_field_vector_lowmem(
    info: FilmInfo, ix: np.ndarray, sites: torch.Tensor
) -> torch.Tensor:
    """A hole's ``A @ 1`` (the effective field of a unit circulating
    current) computed matrix-free: ``Q @ (w mask) - L @ (Lambda mask)``."""
    w = info.weights
    mask = torch.zeros_like(w)
    mask[torch.as_tensor(ix, device=w.device)] = 1.0
    Lambda = torch.as_tensor(info.lambda_info.Lambda[:, 0], dtype=w.dtype, device=w.device)
    return kernels.Q_apply(sites, w, w * mask) - info.laplacian.matvec(Lambda * mask)


def max_materialized_n(dtype: torch.dtype) -> int:
    """The largest interior of a low-memory film that is materialized and
    LU-factorized: ``SUPERSCREEN_TPU_MAX_MATERIALIZED_N`` if set, else what
    :data:`MAX_MATERIALIZED_BYTES` holds at three ``(ni, ni)`` buffers of
    ``dtype``."""
    ceiling = os.environ.get("SUPERSCREEN_TPU_MAX_MATERIALIZED_N")
    if ceiling is not None:
        return int(ceiling)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return math.isqrt(MAX_MATERIALIZED_BYTES // (3 * itemsize))


def factorize_linear_systems(
    device: Device, film_info_dict: Dict[str, FilmInfo]
) -> Tuple[Dict[str, LinearSystem], Dict[str, Dict[str, LinearSystem]]]:
    """Builds and factorizes the linear systems for all films and holes.

    Each dense film's Laplacian is released once its systems are built.
    A low-memory film is LU-factorized from its materialized interior
    system, or, with ``SUPERSCREEN_TPU_LARGE_FACTOR=cg`` or an interior
    above ``SUPERSCREEN_TPU_MAX_MATERIALIZED_N``, left to matrix-free CG.

    Returns:
        ``{film: film_system}`` and ``{film: {hole: hole_system}}``.
    """
    method = linalg.large_factor_method()
    film_systems = {}
    hole_systems = {}
    for film_name, info in film_info_dict.items():
        interior = info.interior_indices
        if info.hole_indices:
            interior = np.setdiff1d(
                interior, np.concatenate(list(info.hole_indices.values()))
            )
        if not info.dense_kernel:
            sites = torch.as_tensor(info.sites, device=info.weights.device)
            hole_systems[film_name] = {
                hole_name: LinearSystem(
                    A=_hole_effective_field_vector_lowmem(info, indices, sites),
                    indices=indices,
                )
                for hole_name, indices in info.hole_indices.items()
            }
            if method == "cg" or len(interior) > max_materialized_n(info.weights.dtype):
                film_systems[film_name] = LinearSystem(
                    A=None,
                    indices=interior,
                    cg_op=_lowmem_operator_pieces(info, interior, sites),
                )
            else:
                A = _build_system_2d_lowmem(info, interior, sites)
                film_systems[film_name] = LinearSystem(
                    A=A, indices=interior, lu_piv=linalg.factor_system(A)
                )
            continue
        Q, weights, laplacian = info.kernel, info.weights, info.laplacian
        Lambda = torch.as_tensor(
            info.lambda_info.Lambda[:, 0], dtype=Q.dtype, device=Q.device
        )
        hole_systems[film_name] = {
            hole_name: LinearSystem(
                A=_build_system_1d(Q, weights, Lambda, laplacian, indices),
                indices=indices,
            )
            for hole_name, indices in info.hole_indices.items()
        }
        A = _build_system_2d(Q, weights, Lambda, laplacian, interior)
        info.laplacian = None
        film_systems[film_name] = LinearSystem(
            A=A, indices=interior, lu_piv=linalg.factor_system(A)
        )
    return film_systems, hole_systems

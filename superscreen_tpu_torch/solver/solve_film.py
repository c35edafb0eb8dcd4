"""Per-film linear systems.

Counterpart of the dense branch of ``superscreen_tpu/solver/solve_film.py``:
each film's system ``A = Q diag(w) - Lambda laplacian`` is restricted to
the film's interior (outside its holes) and LU-factorized on the torch
device; each hole gets the all-rows, hole-columns system whose row sums
give the effective field of a unit circulating current.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import Device
from ..ops import linalg
from .utils import FilmInfo

__all__ = ["LinearSystem", "factorize_linear_systems"]


@dataclass
class LinearSystem:
    """The linear system for a film or hole.

    Args:
        A: The matrix ``Q diag(w) - Lambda laplacian`` restricted to
            ``indices``.
        indices: The mesh indices this system acts on.
        lu_piv: The LU factorization ``(LU, perm)`` of ``-A`` (see
            :func:`superscreen_tpu_torch.ops.linalg.factor_system`), or None.
    """

    A: torch.Tensor
    indices: np.ndarray
    lu_piv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def _build_system_1d(Q, weights, Lambda, laplacian, ix):
    """The 'effective applied field' system: all rows, columns ``ix``."""
    ix = torch.as_tensor(ix, device=Q.device)
    return Q[:, ix] * weights[ix] - Lambda[ix] * laplacian[:, ix]


def _build_system_2d(Q, weights, Lambda, laplacian, ix):
    """The stream-function system restricted to rows and columns ``ix``."""
    ix = torch.as_tensor(ix, device=Q.device)
    rows, cols = ix[:, None], ix[None, :]
    return Q[rows, cols] * weights[ix] - Lambda[ix] * laplacian[rows, cols]


def factorize_linear_systems(
    device: Device, film_info_dict: Dict[str, FilmInfo]
) -> Tuple[Dict[str, LinearSystem], Dict[str, Dict[str, LinearSystem]]]:
    """Builds and LU-factorizes the linear systems for all films and holes.

    Each film's dense Laplacian is released once its systems are built.

    Returns:
        ``{film: film_system}`` and ``{film: {hole: hole_system}}``.
    """
    film_systems = {}
    hole_systems = {}
    for film_name, info in film_info_dict.items():
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
        interior = info.interior_indices
        if info.hole_indices:
            interior = np.setdiff1d(
                interior, np.concatenate(list(info.hole_indices.values()))
            )
        A = _build_system_2d(Q, weights, Lambda, laplacian, interior)
        info.laplacian = None
        film_systems[film_name] = LinearSystem(
            A=A, indices=interior, lu_piv=linalg.factor_system(A)
        )
    return film_systems, hole_systems

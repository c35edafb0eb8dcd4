"""Dense linear algebra for the film systems.

Counterpart of the dense LU path of ``superscreen_tpu/ops/linalg.py``:
``-A`` is LU-factorized with :func:`torch.linalg.lu_factor` on the
system's device, and solves use safeguarded fixed-count iterative
refinement so that each returned column is the iterate with the smallest
residual.
"""

from typing import Callable, Tuple

import torch

__all__ = ["factor_system", "lu_solve", "refine_safeguarded"]


def _pivots_to_permutation(piv: torch.Tensor) -> torch.Tensor:
    """The row permutation ``perm`` of LAPACK-style (1-based, sequential
    swap) pivots: ``M[perm] = L U`` for ``(LU, piv) = lu_factor(M)``."""
    perm = list(range(piv.shape[-1]))
    for i, j in enumerate((piv.cpu() - 1).tolist()):
        perm[i], perm[j] = perm[j], perm[i]
    return torch.tensor(perm, device=piv.device)


def factor_system(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LU factors of ``-A`` (solves are against ``-A``): the packed
    ``LU`` and the row permutation ``perm`` with ``(-A)[perm] = L U``."""
    lu, piv = torch.linalg.lu_factor(-A)
    return lu, _pivots_to_permutation(piv)


def lu_solve(lu_perm: Tuple[torch.Tensor, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Solves ``(-A) x = h`` for ``h`` of shape ``(n,)`` or ``(n, k)``.

    Two triangular solves read the triangles of the packed ``LU`` in
    place; ``torch.linalg.lu_solve`` would first unpack ``L`` and ``U``
    into new ``(n, n)`` buffers on every call.
    """
    lu, perm = lu_perm
    squeeze = h.ndim == 1
    rhs = (h[:, None] if squeeze else h)[perm]
    y = torch.linalg.solve_triangular(lu, rhs, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(lu, y, upper=True)
    return x[:, 0] if squeeze else x


def refine_safeguarded(
    solve: Callable[[torch.Tensor], torch.Tensor],
    A: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    steps: int,
) -> torch.Tensor:
    """Iterative refinement of ``(-A) x = h`` (``h``, ``x`` of shape
    ``(n, k)``) that returns, per column, the iterate with the smallest
    residual norm, so refinement never makes an answer worse.

    The residual ``h + A x`` is a full-precision matrix product: the
    caller keeps TF32 off, since a low-precision residual makes the
    refinement diverge.
    """
    r = h + A @ x
    best_x = x
    best_r2 = torch.sum(r * r, dim=0)
    for _ in range(steps):
        x = x + solve(r)
        r = h + A @ x
        r2 = torch.sum(r * r, dim=0)
        best_x = torch.where((r2 < best_r2)[None, :], x, best_x)
        best_r2 = torch.minimum(r2, best_r2)
    return best_x

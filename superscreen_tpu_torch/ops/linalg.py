"""Linear algebra for the film systems.

Counterpart of the LU and matrix-free paths of
``superscreen_tpu/ops/linalg.py``: ``-A`` is LU-factorized with
:func:`torch.linalg.lu_factor` on the system's device, and solves use
safeguarded fixed-count iterative refinement so that each returned column
is the iterate with the smallest residual.  A film whose system is not
materialized is solved on the matrix-free operator :func:`brandt_matvec`
with a Jacobi preconditioner: by CG, or by BiCGStab when an inhomogeneous
Lambda makes the operator non-symmetric.
"""

import logging
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import kernels

logger = logging.getLogger("solve")

__all__ = [
    "factor_system",
    "lu_solve",
    "lu_solve_refined",
    "refine_safeguarded",
    "system_residual",
    "large_factor_method",
    "brandt_matvec",
    "brandt_cg_solve_host",
    "brandt_bicgstab_solve_host",
    "matrix_free_solve_host",
    "CG_STATS",
]

#: Totals over the matrix-free CG solves since the last reset: ``solves``,
#: ``iterations``, and the largest final relative residual ``max_residual``.
CG_STATS = {"solves": 0, "iterations": 0, "max_residual": 0.0}


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


def lu_solve_refined(
    A: torch.Tensor,
    lu_perm: Tuple[torch.Tensor, torch.Tensor],
    h: torch.Tensor,
    refine_steps: int = 2,
) -> torch.Tensor:
    """Solves ``(-A) x = h`` with ``refine_steps`` rounds of plain
    iterative refinement (``x += lu_solve(h + A @ x)``), for the solves
    outside the sweep: the terminal bootstrap and the vortex response
    columns."""
    squeeze = h.ndim == 1
    if squeeze:
        h = h[:, None]
    x = lu_solve(lu_perm, h)
    for _ in range(refine_steps):
        x = x + lu_solve(lu_perm, system_residual(A, h, x))
    return x[:, 0] if squeeze else x


#: Row-block size of :func:`system_residual`'s float64 pass.
_RESIDUAL_BLOCK = 2048
#: Fewest right-hand-side columns for which :func:`system_residual`
#: accumulates a float32 system's residual in float64.
F64_RESIDUAL_MIN_COLS = 2


def system_residual(A: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The residual ``h + A @ x`` of ``(-A) x = h`` (``h``, ``x`` of shape
    ``(n, k)``), in the dtype of ``h``.

    ``A x`` cancels to a small fraction of ``|A| |x|`` (the Brandt kernel's
    rows and the Laplacian's both sum to nearly nothing on a smooth
    stream), so a float32 product carries a rounding error that is large
    against the residual itself.  For a float32 system with at least
    :data:`F64_RESIDUAL_MIN_COLS` columns the product is therefore
    accumulated in float64, over row blocks of ``A`` widened on the fly.
    """
    if A.dtype != torch.float32 or x.shape[1] < F64_RESIDUAL_MIN_COLS:
        return h + A @ x
    r = torch.empty_like(h)
    x64 = x.double()
    for lo in range(0, A.shape[0], _RESIDUAL_BLOCK):
        rows = slice(lo, lo + _RESIDUAL_BLOCK)
        r[rows] = torch.addmm(h[rows].double(), A[rows].double(), x64)
    return r


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

    The residual comes from :func:`system_residual`; the caller keeps
    TF32 off, since a low-precision residual makes the refinement diverge.
    """
    r = system_residual(A, h, x)
    best_x = x
    best_r2 = torch.sum(r * r, dim=0)
    for _ in range(steps):
        x = x + solve(r)
        r = system_residual(A, h, x)
        r2 = torch.sum(r * r, dim=0)
        best_x = torch.where((r2 < best_r2)[None, :], x, best_x)
        best_r2 = torch.minimum(r2, best_r2)
    return best_x


def large_factor_method() -> str:
    """Reads and validates ``SUPERSCREEN_TPU_LARGE_FACTOR``, as the JAX
    package does (a typo raises instead of selecting a default).  ``"cg"``
    solves low-memory films matrix-free; every other value factorizes
    their materialized system with the LU above, as the JAX package does
    on the CPU for every method."""
    method = os.environ.get("SUPERSCREEN_TPU_LARGE_FACTOR", "inv")
    if method not in ("schur", "inv", "chol", "schulz", "cg"):
        raise ValueError(
            f"Unknown SUPERSCREEN_TPU_LARGE_FACTOR {method!r} "
            "(expected 'schur', 'inv', 'chol', 'schulz', or 'cg')."
        )
    return method


def brandt_matvec(op: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``A @ x`` for the Brandt system restricted to a film's
    interior: ``A = (-q_sub + diag(d)) diag(w) - L_lam``, with the q-block
    applied by the ``q_apply`` kernel and never stored.

    Args:
        op: Operator pieces: ``sub_sites (ni, 2)``, ``w_sub (ni,)``,
            ``diag (ni,)`` (the regularized Brandt diagonal, computed from
            the full site set), and the Lambda-scaled restricted Laplacian
            (plus, for an inhomogeneous Lambda, the ``(grad Lambda) . grad``
            term) as COO triplets ``lap_rows``, ``lap_cols``, ``lap_vals``;
            ``nonsym`` is True when that term is present.
        x: ``(ni,)`` or ``(ni, B)``.

    Returns:
        ``A @ x``, shaped like ``x``.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    wx = op["w_sub"][:, None] * x
    Ax = -kernels.q_apply(op["sub_sites"], wx) + op["diag"][:, None] * wx
    contrib = op["lap_vals"][:, None] * x[op["lap_cols"]]
    Ax = Ax - torch.zeros_like(Ax).index_add_(0, op["lap_rows"], contrib)
    return Ax[:, 0] if squeeze else Ax


def _jacobi_minv(op: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Jacobi preconditioner diagonal for ``P = A diag(1/w)``, ``(ni, 1)``."""
    w = op["w_sub"]
    rows, cols, vals = op["lap_rows"], op["lap_cols"], op["lap_vals"]
    lam_diag = torch.zeros_like(w).index_add_(
        0, rows, torch.where(rows == cols, vals, torch.zeros_like(vals))
    )
    p_diag = op["diag"] - lam_diag / w
    return torch.where(p_diag.abs() > 0, 1.0 / p_diag, torch.ones_like(p_diag))[:, None]


def _warn_if_unconverged(res: float, tol: float, method: str) -> None:
    """A matrix-free solve returns its final iterate either way; warn when
    it stopped above ``tol`` (a diagnostic, not a fallback)."""
    if not np.isfinite(res) or res > tol:
        logger.warning(
            f"Matrix-free {method} solve did NOT converge: final relative "
            f"residual {res:.3e} > tol {tol:.0e}. The returned stream "
            f"function may be inaccurate; consider raising "
            f"SUPERSCREEN_TPU_MAX_MATERIALIZED_N to use a direct solve."
        )


def brandt_cg_solve_host(
    op: Dict[str, torch.Tensor],
    h: torch.Tensor,
    tol: float = 1e-6,
    maxiter: int = 1000,
    chunk: int = 25,
) -> torch.Tensor:
    """Solves ``(-A) x = h`` matrix-free by Jacobi-preconditioned CG.

    ``P = A diag(1/w)`` is symmetric positive definite, so CG runs on
    ``P y = -h`` and ``x = y / w``.  Iterations run in chunks of ``chunk``;
    after each chunk the largest relative residual over the columns is
    read on the host (one synchronisation), and the solve stops below
    ``tol`` or at ``maxiter``.  Converged columns are held still by the
    zero-guarded step sizes.

    Args:
        op: Operator pieces (see :func:`brandt_matvec`).
        h: ``(ni,)`` or ``(ni, B)`` right-hand sides.

    Returns:
        ``x``, shaped like ``h``.
    """
    squeeze = h.ndim == 1
    if squeeze:
        h = h[:, None]
    w = op["w_sub"][:, None]
    minv = _jacobi_minv(op)
    b = -h
    bnorm = torch.clamp(torch.linalg.vector_norm(b, dim=0), min=1e-30)
    x = torch.zeros_like(b)
    r = b
    z = minv * r
    p = z
    rz = torch.sum(r * z, dim=0)
    zero = torch.zeros_like(rz)
    done = 0
    res = np.inf
    while done < maxiter:
        for _ in range(min(chunk, maxiter - done)):
            Ap = brandt_matvec(op, p / w)
            pAp = torch.sum(p * Ap, dim=0)
            alpha = torch.where(pAp.abs() > 0, rz / pAp, zero)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * Ap
            z = minv * r
            rz_new = torch.sum(r * z, dim=0)
            beta = torch.where(rz.abs() > 0, rz_new / rz, zero)
            p = z + beta[None, :] * p
            rz = rz_new
        done += min(chunk, maxiter - done)
        res = float(torch.max(torch.linalg.vector_norm(r, dim=0) / bnorm))
        if res < tol or not np.isfinite(res):
            break
    _warn_if_unconverged(res, tol, "CG")
    CG_STATS["solves"] += 1
    CG_STATS["iterations"] += done
    CG_STATS["max_residual"] = max(CG_STATS["max_residual"], res)
    x = x / w
    return x[:, 0] if squeeze else x


def brandt_bicgstab_solve_host(
    op: Dict[str, torch.Tensor],
    h: torch.Tensor,
    tol: float = 1e-6,
    maxiter: int = 1000,
    chunk: int = 25,
) -> torch.Tensor:
    """Solves ``(-A) x = h`` matrix-free by BiCGStab with a right Jacobi
    preconditioner, for an operator that carries the non-symmetric
    ``(grad Lambda) . grad`` term of an inhomogeneous Lambda.

    The iteration runs on ``K u = -h`` with ``K u = P (minv u)`` and
    ``P = A diag(1/w)``; ``x = minv u / w``.  Like
    :func:`brandt_cg_solve_host` it runs in chunks of ``chunk`` iterations
    with one residual read on the host per chunk, and converged or
    broken-down columns are held still by the zero-guarded scalars.

    Args:
        op: Operator pieces (see :func:`brandt_matvec`).
        h: ``(ni,)`` or ``(ni, B)`` right-hand sides.

    Returns:
        ``x``, shaped like ``h``.
    """
    squeeze = h.ndim == 1
    if squeeze:
        h = h[:, None]
    w = op["w_sub"][:, None]
    minv = _jacobi_minv(op)

    def K_matvec(u):
        return brandt_matvec(op, (minv * u) / w)

    def guarded_div(num, den):
        return torch.where(den.abs() > 0, num / den, torch.zeros_like(num))

    b = -h
    bnorm = torch.clamp(torch.linalg.vector_norm(h, dim=0), min=1e-30)
    x = torch.zeros_like(b)
    r = rhat = b
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones(b.shape[1], dtype=b.dtype, device=b.device)
    done = 0
    res = np.inf
    while done < maxiter:
        for _ in range(min(chunk, maxiter - done)):
            rho_new = torch.sum(rhat * r, dim=0)
            beta = guarded_div(rho_new, rho) * guarded_div(alpha, omega)
            p = r + beta[None, :] * (p - omega[None, :] * v)
            v = K_matvec(p)
            alpha = guarded_div(rho_new, torch.sum(rhat * v, dim=0))
            s = r - alpha[None, :] * v
            t = K_matvec(s)
            omega = guarded_div(torch.sum(t * s, dim=0), torch.sum(t * t, dim=0))
            x = x + alpha[None, :] * p + omega[None, :] * s
            r = s - omega[None, :] * t
            rho = rho_new
        done += min(chunk, maxiter - done)
        res = float(torch.max(torch.linalg.vector_norm(r, dim=0) / bnorm))
        if res < tol or not np.isfinite(res):
            break
    _warn_if_unconverged(res, tol, "BiCGStab")
    CG_STATS["solves"] += 1
    CG_STATS["iterations"] += done
    CG_STATS["max_residual"] = max(CG_STATS["max_residual"], res)
    x = (minv * x) / w
    return x[:, 0] if squeeze else x


def matrix_free_solve_host(op: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """A matrix-free solve of ``(-A) x = h``: CG for a symmetric operator,
    BiCGStab when the operator carries the non-symmetric
    inhomogeneous-Lambda term (``op["nonsym"]``)."""
    if op.get("nonsym", False):
        return brandt_bicgstab_solve_host(op, h)
    return brandt_cg_solve_host(op, h)

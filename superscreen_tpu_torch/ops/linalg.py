"""Linear algebra for the film systems.

Counterpart of the factorization and solve paths of
``superscreen_tpu/ops/linalg.py``.  :func:`factor_system` factorizes a film
system ``A`` (solves are against ``-A``): a system on the CPU or of at most
:data:`LU_MAX_N_TPU` unknowns is LU-factorized with
:func:`torch.linalg.lu_factor`, as in the JAX package.  A larger one on
the card without the column scaling ``w`` that makes ``P = A diag(1/w)``
symmetric positive definite (a film with an inhomogeneous Lambda) is
inverted from its LU, ``("inv", M, None)`` with ``M = (-A)^-1``
(:func:`_lu_explicit_inverse`), where the JAX package inverts ``P_s``, the
symmetric part of ``P``, which leaves ``||I + M A||`` ~0.3 on such a
film.  A larger one with ``w`` takes the route of
``SUPERSCREEN_TPU_LARGE_FACTOR`` (:func:`large_factor_method`), each on
``P_s``:

- ``"inv"`` (the default): Cholesky, the triangular inverse and the
  product ``P_s^-1 = L^-T L^-1``, in place in one ``(n, n)`` buffer beside
  ``A`` (:func:`_chol_explicit_inverse`), as the solution operator
  ``("inv", M, w)`` with ``M = -P_s^-1 / w``: a solve is one product.
- ``"chol"``: the factor ``("chol", L, w)``; ``x = -cho_solve(L, h) / w``.
- ``"schur"`` (and ``"cg"`` on a film that is materialized anyway) and
  ``"schulz"``: the explicit inverse bodies of :mod:`.rows` on one slot,
  ``("inv", M, w)``.

A film past the single-device dense ceiling, kept dense because a
factorization mesh is installed (:mod:`superscreen_tpu_torch.parallel`),
has a row-sharded system (:class:`.rows.RowSharded`) and is inverted over
the mesh: ``("inv", M, w)`` with ``M`` row-sharded.  An installed mesh
also takes every large film on the card that has ``w``, as in the JAX
package.

Solves use safeguarded fixed-count iterative refinement so that each
returned column is the iterate with the smallest residual; :func:`lu_solve`
and the refined solves take every form of the factors.  A film whose
system is not materialized is solved on the matrix-free operator
:func:`brandt_matvec` with a Jacobi preconditioner: by CG, or by BiCGStab
when an inhomogeneous Lambda makes the operator non-symmetric.
"""

import logging
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import tracing
from . import kernels, rows
from .fem import gather_matvec
from .rows import RowSharded

logger = logging.getLogger("solve")

__all__ = [
    "LU_MAX_N_TPU",
    "factor_system",
    "factor_kind",
    "factors_dtype",
    "lu_solve",
    "lu_solve_refined",
    "refine_safeguarded",
    "refined_solve",
    "mixed_preconditioner",
    "system_residual",
    "large_factor_method",
    "brandt_matvec",
    "brandt_matvec64",
    "brandt_cg_solve_host",
    "brandt_bicgstab_solve_host",
    "matrix_free_solve_host",
    "matrix_free_response_diagonal",
    "CG_STATS",
]

#: Totals over the matrix-free CG solves since the last reset: ``solves``,
#: ``iterations``, and the largest final relative residual ``max_residual``.
CG_STATS = {"solves": 0, "iterations": 0, "max_residual": 0.0}


#: Interior unknowns above which a film system on the card takes the route
#: of ``SUPERSCREEN_TPU_LARGE_FACTOR`` instead of LU: the JAX package's
#: threshold of the same name, so that the same films take the same route
#: in both packages.  A system on the CPU always takes LU, as it does on
#: the JAX package's CPU backend.
LU_MAX_N_TPU = 12288

#: Rows and columns of one block of the in-place Cholesky, triangular
#: inverse and product of the ``"inv"`` and ``"chol"`` routes (the JAX
#: package's block).
FACTOR_BLOCK = 2048


def _pivots_to_permutation(piv: torch.Tensor) -> torch.Tensor:
    """The row permutation ``perm`` of LAPACK-style (1-based, sequential
    swap) pivots: ``M[perm] = L U`` for ``(LU, piv) = lu_factor(M)``."""
    perm = list(range(piv.shape[-1]))
    for i, j in enumerate((piv.cpu() - 1).tolist()):
        perm[i], perm[j] = perm[j], perm[i]
    return torch.tensor(perm, device=piv.device)


def _on_cpu(A) -> bool:
    """True where ``A`` lies on the CPU, where every system is
    LU-factorized (the JAX package's ``_on_cpu``)."""
    return A.device.type == "cpu"


def _spd_part(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``P_s = (P + P^T) / 2`` for ``P = A diag(1/w)``: one new ``(n, n)``
    matrix, symmetrised in place piece by piece (``A`` is only read)."""
    X = A / w[None, :]
    rows._symmetrize_(RowSharded([X]))
    return X


def _cholesky_(X: torch.Tensor, block: int) -> torch.Tensor:
    """The lower Cholesky factor of the SPD ``X``, in place, by block
    columns of ``block``: each diagonal block's Cholesky, the panel below
    it by a triangular solve, and the lower block columns of the trailing
    matrix updated by one product each.  Only the lower triangle is read;
    the upper is zeroed at the end.  A block that is not positive definite
    raises (:func:`torch.linalg.cholesky`)."""
    n = X.shape[0]
    for j in range(0, n, block):
        j1 = min(j + block, n)
        L_jj = torch.linalg.cholesky(X[j:j1, j:j1])
        X[j:j1, j:j1] = L_jj
        if j1 == n:
            break
        panel = torch.linalg.solve_triangular(L_jj.mT, X[j1:, j:j1], upper=True, left=False)
        X[j1:, j:j1] = panel
        for c in range(j1, n, block):
            c1 = min(c + block, n)
            X[c:, c:c1].addmm_(panel[c - j1 :], panel[c - j1 : c1 - j1].mT, alpha=-1)
        del panel
    return X.tril_()


def _tril_inverse_(X: torch.Tensor, block: int, packed: bool = False) -> torch.Tensor:
    """The inverse of the lower-triangular ``X`` (zeros above the
    diagonal), in place, from the last block column to the first: with the
    trailing block ``L22^-1`` already in place, the block column below the
    diagonal becomes ``-L22^-1 L21 L11^-1``, its product formed one block
    row at a time over the lower triangle only.  With ``packed`` the strict
    upper triangle holds another factor (the other triangle of a packed
    LU), which is neither read nor written."""
    n = X.shape[0]
    for j in reversed(range(0, n, block)):
        j1 = min(j + block, n)
        eye = torch.eye(j1 - j, dtype=X.dtype, device=X.device)
        D_inv = torch.linalg.solve_triangular(X[j:j1, j:j1], eye, upper=False)
        if j1 < n:
            T = torch.empty((n - j1, j1 - j), dtype=X.dtype, device=X.device)
            for r in range(j1, n, block):
                r1 = min(r + block, n)
                T_r = T[r - j1 : r1 - j1]
                if packed:
                    torch.mm(X[r:r1, r:r1].tril(), X[r:r1, j:j1], out=T_r)
                    if r > j1:
                        T_r.addmm_(X[r:r1, j1:r], X[j1:r, j:j1])
                else:
                    torch.mm(X[r:r1, j1:r1], X[j1:r1, j:j1], out=T_r)
            X[j1:, j:j1] = (T @ D_inv).neg_()
            del T
        if packed:
            D_inv.add_(X[j:j1, j:j1].triu(1))
        X[j:j1, j:j1] = D_inv
    return X


def _lower_gram_(X: torch.Tensor, block: int) -> torch.Tensor:
    """``W^T W`` for the lower-triangular ``W`` held in ``X``, in place (the
    LAPACK ``lauum`` order): block row ``i`` of the lower triangle is
    ``W[i:, I]^T W[i:, :i1]``, which reads only rows not yet overwritten;
    the upper triangle is then mirrored from the lower."""
    n = X.shape[0]
    for i in range(0, n, block):
        i1 = min(i + block, n)
        X[i:i1, :i1] = X[i:, i:i1].mT @ X[i:, :i1]
    for i in range(0, n, block):
        i1 = min(i + block, n)
        X[i:i1, i1:] = X[i1:, i:i1].mT
    return X


def _chol_explicit_inverse(A: torch.Tensor, w: torch.Tensor, block: int) -> torch.Tensor:
    """The solution operator ``M = -P_s^-1 / w`` of ``(-A) x = h`` by the
    ``"inv"`` route, the port of the JAX package's
    ``_jax_chol_explicit_inverse_from_A``: Cholesky of ``P_s``, the
    triangular inverse and ``L^-T L^-1``, all in place in the one new
    ``(n, n)`` buffer of :func:`_spd_part`, then its rows scaled by
    ``-1/w``.  Beside ``A`` the route holds that buffer and panels of at
    most ``n x block``, within the three matrices that the materialized
    ceiling allows (``solver.solve_film.LU_PEAK_BUFFERS``)."""
    X = _cholesky_(_spd_part(A, w), block)
    _lower_gram_(_tril_inverse_(X, block), block)
    return X.div_(w[:, None]).neg_()


def _transpose_(S: torch.Tensor, block: int) -> torch.Tensor:
    """The square ``S`` transposed in place, one pair of ``block``-sized
    blocks at a time."""
    n = S.shape[0]
    for i in range(0, n, block):
        i1 = min(i + block, n)
        S[i:i1, i:i1] = S[i:i1, i:i1].mT.clone()
        for c in range(i1, n, block):
            c1 = min(c + block, n)
            upper = S[i:i1, c:c1].clone()
            S[i:i1, c:c1] = S[c:c1, i:i1].mT
            S[c:c1, i:i1] = upper.mT
    return S


def _lu_explicit_inverse(A: torch.Tensor, block: int) -> torch.Tensor:
    """The solution operator ``M = (-A)^-1`` of a system without the
    symmetric scaling (an inhomogeneous Lambda), from the partial-pivot LU
    ``A[perm] = L U``, in place in the LU's one new ``(n, n)`` buffer (the
    LAPACK ``getri`` order): ``U`` inverted in place through the lower
    triangle of its transposed view (:func:`_tril_inverse_`, ``packed``),
    then ``Z L = U^-1`` solved for ``Z = U^-1 L^-1`` one block column at a
    time from the right, each block column of ``L`` first moved to an
    ``n x block`` panel; the column-major buffer transposed in place to
    rows, and ``M = -Z[:, perm^-1]`` permuted and negated one block of rows
    at a time.  Beside ``A`` the route holds that buffer and panels, within
    the three matrices that the materialized ceiling allows
    (``solver.solve_film.LU_PEAK_BUFFERS``)."""
    F, piv = torch.linalg.lu_factor(A)
    inv_perm = torch.argsort(_pivots_to_permutation(piv))
    n = F.shape[0]
    _tril_inverse_(F.mT, block, packed=True)
    for j in reversed(range(0, n, block)):
        j1 = min(j + block, n)
        W = F[j:, j:j1].tril(-1)
        F[j:j1, j:j1] = F[j:j1, j:j1].triu()
        if j1 < n:
            F[j1:, j:j1] = 0
            F[:, j:j1].addmm_(F[:, j1:], W[j1 - j :], alpha=-1)
        F[:, j:j1] = torch.linalg.solve_triangular(
            W[: j1 - j], F[:, j:j1], upper=False, left=False, unitriangular=True
        )
        del W
    # lu_factor's buffer is column-major: transposed in place, its
    # transposed view holds Z row by row.
    Z = _transpose_(F.mT, block)
    for i in range(0, n, block):
        i1 = min(i + block, n)
        Z[i:i1] = Z[i:i1].index_select(1, inv_perm).neg_()
    return Z


@tracing.traced("factorize.factor")
def factor_system(A, weights_col=None, force_sharded: bool = False):
    """Factorizes the film system ``A`` (solves are against ``-A``).

    LU factors ``(LU, perm)`` of ``-A`` (the packed ``LU`` and the row
    permutation with ``(-A)[perm] = L U``) for a system on the CPU or of at
    most :data:`LU_MAX_N_TPU` unknowns.  A larger system on the card
    without ``weights_col``, the column scaling ``w`` that makes ``A / w``
    symmetric positive definite, which a film with an inhomogeneous Lambda
    does not have (its ``(grad Lambda) . grad`` term is not symmetric), is
    inverted from its LU: ``("inv", M, None)`` with ``M = (-A)^-1``
    (:func:`_lu_explicit_inverse`).  A larger system on the card with
    ``weights_col`` is inverted over an installed
    factorization mesh (:func:`parallel.sharding.sharded_inverse_of_system`,
    ``("inv", M, w)`` with ``M`` row-sharded), else factorized by the route
    of :func:`large_factor_method`: ``("inv", M, w)`` with the solution
    operator ``M`` (``"inv"``, ``"schur"``, ``"schulz"``, and ``"cg"`` on a
    system that is materialized anyway, which takes ``"schur"``), or
    ``("chol", L, w)``.  A route whose Cholesky meets a block that is not
    positive definite raises; no route retries another.

    ``force_sharded`` marks a film past the single-device dense ceiling
    that stayed dense only because a factorization mesh is installed (as
    in the JAX package, on every backend): its system ``A`` (a
    :class:`RowSharded` or a tensor) is inverted row-sharded over the
    mesh.  The port's own factorization
    (:func:`solver.solve_film.factorize_linear_systems`) knows the mesh and
    calls :func:`parallel.sharding.sharded_inverse_of_system` itself; this
    flag keeps the JAX package's call working."""
    from ..parallel import sharding

    if force_sharded:
        mesh = sharding.factorization_mesh()
        if mesh is None or mesh.shape["model"] <= 1:
            raise ValueError(
                "force_sharded factorization requires an installed "
                "factorization mesh with a model axis > 1 "
                "(parallel.set_factorization_mesh)."
            )
        return ("inv", sharding.sharded_inverse_of_system(mesh, A, weights_col), weights_col)
    if _on_cpu(A) or A.shape[0] <= LU_MAX_N_TPU:
        lu, piv = torch.linalg.lu_factor(-A)
        return lu, _pivots_to_permutation(piv)
    if weights_col is None:
        return ("inv", _lu_explicit_inverse(A, FACTOR_BLOCK), None)
    w = weights_col
    mesh = sharding.factorization_mesh()
    if mesh is not None and mesh.shape["model"] > 1:
        return ("inv", sharding.sharded_inverse_of_system(mesh, A, w), w)
    method = large_factor_method()
    if method == "inv":
        return ("inv", _chol_explicit_inverse(A, w, FACTOR_BLOCK), w)
    if method == "chol":
        return ("chol", _cholesky_(_spd_part(A, w), FACTOR_BLOCK), w)
    if method == "schulz":
        return ("inv", rows.schulz_inverse_rows(RowSharded([A]), w).blocks[0], w)
    return ("inv", rows.schur_inverse_rows(RowSharded([A]), w, leaf=rows.SCHUR_LEAF).blocks[0], w)


def factor_kind(factors) -> str:
    """``"inv"``, ``"chol"`` or ``"lu"``: the form of the factors that
    :func:`factor_system` returned."""
    return factors[0] if isinstance(factors[0], str) else "lu"


def factors_dtype(factors) -> torch.dtype:
    """The dtype the factors solve in: the packed ``LU``'s, ``M``'s or
    ``L``'s."""
    return factors[0].dtype if factor_kind(factors) == "lu" else factors[1].dtype


def lu_solve(lu_piv, h: torch.Tensor) -> torch.Tensor:
    """Solves ``(-A) x = h`` for ``h`` of shape ``(n,)`` or ``(n, k)``.

    LU factors ``(LU, perm)``: two triangular solves read the triangles of
    the packed ``LU`` in place; ``torch.linalg.lu_solve`` would first
    unpack ``L`` and ``U`` into new ``(n, n)`` buffers on every call.  Each
    such solve counts in ``tracing.TRIANGULAR_SOLVES``.
    ``("inv", M, w)`` (``w`` None for an inverse from LU): the product
    ``M h`` (row by row for a row-sharded ``M``, gathered on ``h``'s
    device).  ``("chol", L, w)``: ``A = P diag(w)`` with ``P = L L^T``, so
    ``x = -cho_solve(L, h) / w``.
    """
    kind = factor_kind(lu_piv)
    if kind == "inv":
        return lu_piv[1] @ h
    squeeze = h.ndim == 1
    rhs = h[:, None] if squeeze else h
    if kind == "chol":
        _, L, w = lu_piv
        x = torch.cholesky_solve(rhs, L).div_(w[:, None]).neg_()
    else:
        lu, perm = lu_piv
        tracing.count(tracing.TRIANGULAR_SOLVES)
        y = torch.linalg.solve_triangular(lu, rhs[perm], upper=False, unitriangular=True)
        x = torch.linalg.solve_triangular(lu, y, upper=True)
    return x[:, 0] if squeeze else x


def lu_solve_refined(
    A: torch.Tensor,
    lu_piv,
    h: torch.Tensor,
    refine_steps: int = 2,
) -> torch.Tensor:
    """Solves ``(-A) x = h`` with ``refine_steps`` rounds of plain
    iterative refinement (``x += lu_solve(h + A @ x)``, the residual from
    :func:`system_residual`), for the solves outside the sweep: the
    terminal bootstrap and the vortex response columns.  The factors are
    any form :func:`lu_solve` takes.

    A float64 ``A`` with float32 factors is a high-precision system (see
    :mod:`superscreen_tpu_torch.solver.refine`): it is solved to float64
    accuracy by :func:`refined_solve`, with the factors as preconditioner.
    """
    if factors_dtype(lu_piv) != A.dtype:
        return refined_solve(A, mixed_preconditioner(lu_piv, A.dtype), h)
    squeeze = h.ndim == 1
    if squeeze:
        h = h[:, None]
    x = lu_solve(lu_piv, h)
    for _ in range(refine_steps):
        x = x + lu_solve(lu_piv, system_residual(A, h, x))
    return x[:, 0] if squeeze else x


def system_residual(A: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The residual ``h + A @ x`` of ``(-A) x = h`` (``h``, ``x`` of shape
    ``(n, k)``), in the dtype of ``h``.

    ``A x`` cancels to a small fraction of ``|A| |x|`` (the Brandt kernel's
    rows and the Laplacian's both sum to nearly nothing on a smooth
    stream), so a float32 product carries a rounding error that is large
    against the residual itself: refinement on it stalls near 1e-4 of the
    streams, or follows the product's noise.  The residual of a float32
    system is therefore formed in float64 for any number of columns, by
    :func:`ops.kernels.residual_f64`, which reads the float32 ``A`` once,
    takes ``x`` and ``h`` as they are and rounds once to ``h``'s dtype.
    A row-sharded ``A`` runs it on each slot's rows.
    """
    if A.dtype != torch.float32:
        return h + A @ x
    if isinstance(A, RowSharded):
        return A.residual_f64(x, h, out_dtype=h.dtype)
    return kernels.residual_f64(A, x, h, out_dtype=h.dtype)


def mixed_preconditioner(lu_piv, dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """The factors (any form :func:`lu_solve` takes) of a lower-precision
    copy of ``-A`` as an approximate solver for right-hand sides of
    ``dtype``: cast down, solve, cast up."""
    low = factors_dtype(lu_piv)

    def precond(rhs: torch.Tensor) -> torch.Tensor:
        return lu_solve(lu_piv, rhs.to(low)).to(dtype)

    return precond


def refined_solve(
    A64: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor],
    h64: torch.Tensor,
    rtol: float = 1e-12,
    max_steps: int = 20,
) -> torch.Tensor:
    """Solves ``(-A) x = h`` to float64 accuracy given only a low-precision
    solver for the same system.

    ``precond(r)`` returns an approximate solution of ``(-A) x = r``
    (typically the float32 factorization, see
    :func:`mixed_preconditioner`).  Refinement iterates
    ``x += precond(h + A @ x)`` with the residual in float64, keeps the
    best iterate per column, and stops once every residual is below
    ``rtol * |h|`` or none improves.  A stall above 1e-8 is logged (a
    diagnostic: the best iterate is returned either way).

    Args:
        A64: ``(n, n)`` float64 system, on the device of ``h64``.
        h64: ``(n,)`` or ``(n, k)`` float64 right-hand sides.

    Returns:
        ``x``, shaped like ``h64``.
    """
    squeeze = h64.ndim == 1
    H = h64[:, None] if squeeze else h64
    href = torch.clamp(torch.linalg.vector_norm(H, dim=0), min=torch.finfo(H.dtype).tiny)
    x = precond(H)
    r = H + A64 @ x
    best_x = x
    best_r = torch.linalg.vector_norm(r, dim=0)
    for _ in range(max_steps):
        if bool(tracing.to_host(torch.all(best_r <= rtol * href))):
            break
        x = x + precond(r)
        r = H + A64 @ x
        rn = torch.linalg.vector_norm(r, dim=0)
        improved = rn < best_r
        if not bool(tracing.to_host(improved.any())):
            break
        best_x = torch.where(improved[None, :], x, best_x)
        best_r = torch.minimum(rn, best_r)
    worst = float(tracing.to_host(torch.max(best_r / href)))
    if worst > 1e-8:
        logger.warning(
            f"High-precision refinement stalled at relative residual "
            f"{worst:.3e}; the f32 preconditioner may be too inaccurate "
            f"for this system's conditioning."
        )
    return best_x[:, 0] if squeeze else best_x


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
    package does (a typo raises instead of selecting a default): the route
    of :func:`factor_system` for a system on the card above
    :data:`LU_MAX_N_TPU` unknowns (``"inv"``, the default, ``"chol"``,
    ``"schur"`` or ``"schulz"``); ``"cg"`` solves low-memory films
    matrix-free, and a system materialized anyway takes ``"schur"``."""
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
            term) in gather form ``lap_idx``, ``lap_w`` (``(ni, d)``, see
            :func:`ops.fem.gather_form`: a scatter-add of triplets would
            not be reproducible on the card); ``nonsym`` is True when that
            term is present.
        x: ``(ni,)`` or ``(ni, B)``.

    Returns:
        ``A @ x``, shaped like ``x``.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    wx = op["w_sub"][:, None] * x
    Ax = -kernels.q_apply(op["sub_sites"], wx) + op["diag"][:, None] * wx
    Ax = Ax - gather_matvec(op["lap_idx"], op["lap_w"], x)
    return Ax[:, 0] if squeeze else Ax


def _jacobi_minv(op: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Jacobi preconditioner diagonal for ``P = A diag(1/w)``, ``(ni, 1)``."""
    w = op["w_sub"]
    idx, vals = op["lap_idx"], op["lap_w"]
    own_row = idx == torch.arange(idx.shape[0], device=idx.device)[:, None]
    lam_diag = torch.sum(torch.where(own_row, vals, torch.zeros_like(vals)), dim=1)
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
        res = float(tracing.to_host(torch.max(torch.linalg.vector_norm(r, dim=0) / bnorm)))
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
        res = float(tracing.to_host(torch.max(torch.linalg.vector_norm(r, dim=0) / bnorm)))
        if res < tol or not np.isfinite(res):
            break
    _warn_if_unconverged(res, tol, "BiCGStab")
    CG_STATS["solves"] += 1
    CG_STATS["iterations"] += done
    CG_STATS["max_residual"] = max(CG_STATS["max_residual"], res)
    x = (minv * x) / w
    return x[:, 0] if squeeze else x


def brandt_matvec64(op: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """:func:`brandt_matvec` in float64 on float64 copies of the operator
    pieces (made once and kept in ``op``): the true product of the stored
    operator, free of the float32 rounding of its ``ni`` terms per row."""
    if op["diag"].dtype == torch.float64:
        return brandt_matvec(op, x)
    if "f64" not in op:
        op["f64"] = {
            key: value.double() if torch.is_tensor(value) and value.is_floating_point() else value
            for key, value in op.items()
        }
    return brandt_matvec(op["f64"], x.double())


#: Tolerance of the correction solve of :func:`matrix_free_solve_host`: it
#: only has to shrink a residual of ~1e-4 below the solves' own 1e-6.
_CORRECTION_TOL = 1e-3


def matrix_free_solve_host(op: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """A matrix-free solve of ``(-A) x = h``: CG for a symmetric operator,
    BiCGStab when the operator carries the non-symmetric
    inhomogeneous-Lambda term (``op["nonsym"]``).

    In float32 the Krylov recurrence residual drifts from the true one, and
    a solve that stops at 1e-6 ends at a true residual above 1e-4.  So a
    float32 solve is followed by one step of iterative refinement: the true
    residual is formed matrix-free in float64 (:func:`brandt_matvec64`) and
    a second, looser Krylov solve corrects for it."""
    solve = brandt_bicgstab_solve_host if op.get("nonsym", False) else brandt_cg_solve_host
    x = solve(op, h)
    if h.dtype == torch.float32:
        r = h.double() + brandt_matvec64(op, x)
        x = x + solve(op, r.to(h.dtype), tol=_CORRECTION_TOL)
    return x


def _probing_colors(sites, separation: float) -> np.ndarray:
    """Spatial distance-coloring of ``sites`` for inverse-diagonal probing.

    Sites sharing a color are at least ``separation`` apart: sites are
    binned into square cells of side ``separation``, cells are classed by
    their coordinates modulo a 2x2 stride (same-class cells are at least
    ``separation`` apart edge to edge), and sites within one cell get
    distinct occupancy sub-indices.  The number of colors is
    ``4 * max_cell_occupancy``, independent of n at a fixed mesh density.

    Returns:
        ``(n,)`` int colors in ``[0, n_colors)``, densely renumbered.
    """
    sites = np.asarray(sites, dtype=float)
    cell = np.floor(sites / float(separation)).astype(np.int64)
    cell -= cell.min(axis=0)
    cls = (cell[:, 0] % 2) * 2 + (cell[:, 1] % 2)
    flat = cell[:, 0] * (cell[:, 1].max() + 1) + cell[:, 1]
    order = np.argsort(flat, kind="stable")
    occ = np.empty(len(sites), dtype=np.int64)
    sorted_flat = flat[order]
    # Occupancy rank within each cell: position since the cell's first site.
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_flat)) + 1]
    ranks = np.arange(len(sites)) - np.repeat(starts, np.diff(np.r_[starts, len(sites)]))
    occ[order] = ranks
    colors = cls * (occ.max() + 1) + occ
    _, dense = np.unique(colors, return_inverse=True)
    return dense


def matrix_free_response_diagonal(
    op: Dict[str, torch.Tensor],
    *,
    method: str = "auto",
    separation: Optional[float] = None,
    repeats: int = 4,
    chunk: int = 512,
    seed: int = 0,
) -> np.ndarray:
    """Diagonal of ``(-A)^{-1}`` for a matrix-free (CG/BiCGStab) film: the
    response of a unit probe vortex at its own core, per site, without the
    ``(n, n)`` inverse.

    Methods:

    - ``"exact"``: solves ``(-A) X = I`` in ``chunk``-column blocks of
      one-hot right-hand sides (n/chunk batched matrix-free solves).
    - ``"probing"``: colored-Hutchinson estimator.  Sites are
      distance-colored (:func:`_probing_colors`); each repeat draws
      Rademacher signs ``s`` (NumPy, from ``seed``), solves one batched
      system with right-hand sides ``V[:, c] = s * 1[color == c]`` and
      reads ``d_j ~= s_j X[j, color_j]``.  Unbiased, with a per-site
      standard deviation bounded by the response at distance
      ``separation``, shrinking as ``1/sqrt(repeats)``.
    - ``"auto"``: ``"exact"`` when n <= 8192, else ``"probing"``.

    Args:
        op: Matrix-free operator pieces (see :func:`brandt_matvec`).
        method: ``"auto"`` | ``"exact"`` | ``"probing"``.
        separation: Probing color separation in device length units
            (default: 16x the median nearest-neighbour spacing).
        repeats: Independent sign draws averaged in probing mode.
        chunk: Columns per batched solve in exact mode.
        seed: RNG seed of the probing signs.

    Returns:
        ``(n,)`` float64 diagonal of ``(-A)^{-1}`` (NumPy).
    """
    sites = op["sub_sites"].double().cpu().numpy()
    n = sites.shape[0]
    dtype = op["w_sub"].dtype
    like = dict(dtype=dtype, device=op["w_sub"].device)
    if method == "auto":
        method = "exact" if n <= 8192 else "probing"
    if method == "exact":
        diag = np.empty(n, dtype=float)
        for start in range(0, n, chunk):
            cols = torch.arange(start, min(start + chunk, n), device=like["device"])
            k = torch.arange(len(cols), device=like["device"])
            E = torch.zeros((n, len(cols)), **like)
            E[cols, k] = 1.0
            X = matrix_free_solve_host(op, E)
            diag[start : start + len(cols)] = X[cols, k].double().cpu().numpy()
        return diag
    if method != "probing":
        raise ValueError(f"Unknown diagonal method {method!r}.")
    if separation is None:
        from scipy.spatial import cKDTree

        d, _ = cKDTree(sites).query(sites, k=2)
        separation = 16.0 * float(np.median(d[:, 1]))
    colors = _probing_colors(sites, separation)
    n_colors = int(colors.max()) + 1
    logger.info("probing response diagonal: n=%d, %d colors, %d repeats", n, n_colors, repeats)
    rng = np.random.default_rng(seed)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    rows = torch.arange(n, device=like["device"])
    cols = torch.as_tensor(colors, device=like["device"])
    est = np.zeros(n, dtype=float)
    for _ in range(repeats):
        signs = rng.choice(np.array([-1.0, 1.0], dtype=np_dtype), size=n)
        s = torch.as_tensor(signs, device=like["device"])
        V = torch.zeros((n, n_colors), **like)
        V[rows, cols] = s
        X = matrix_free_solve_host(op, V)
        est += signs * X[rows, cols].double().cpu().numpy()
    return est / repeats

"""``torch.autograd.Function``s of the differentiable solve
(:mod:`superscreen_tpu_torch.adjoint`).

Each runs its forward pass on the port's own routes (the
``biot_savart_batch`` kernel on a CUDA tensor, fixed-fan-in gathers, LU
solves against a factorization made outside the graph) and writes its
backward pass by hand, so that the backward pass runs on the same routes:

- :class:`BiotSavartCoupling`: the field of a sheet current at other
  points.  Its VJP is the same sum with sources and destinations swapped,
  one more launch of the same kernel.
- :class:`SparseMatvec`: a COO product in gather form.  Its VJP with
  respect to ``x`` is the gather form of the transposed operator, built
  once with the pattern; a scatter-add (what autograd gives ``x[cols]``)
  runs on atomics on the card, and its gradients would change from run to
  run.
- :class:`BrandtSolve`: ``x = (-A)^-1 rhs`` against a packed LU.  Its VJP
  is one transposed solve against the same LU, and the gradient with
  respect to ``A`` only at the sparse entries through which Lambda enters.
- :class:`DenseProduct`: a product with a constant matrix, whose
  backward pass is a product with the same matrix.

Every backward pass runs after the forward pass's
``highest_matmul_precision`` block has closed, so it pins float32
products to full precision itself.  None of them is differentiable twice
(``once_differentiable``).
"""

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..solver.solve import highest_matmul_precision
from . import kernels, linalg
from .fem import entry_table

__all__ = [
    "SparsePattern",
    "FactoredSystem",
    "BiotSavartCoupling",
    "SparseMatvec",
    "BrandtSolve",
    "DenseProduct",
]


def _highest_precision(backward):
    @functools.wraps(backward)
    def run(ctx, *grads):
        with highest_matmul_precision():
            return backward(ctx, *grads)

    return run


@dataclass(frozen=True)
class SparsePattern:
    """The fixed sparsity pattern of an ``(n_rows, n_cols)`` COO operator,
    in gather form for its product and for its transpose's.

    Entry ``k`` sits at ``(rows[k], cols[k])``.  ``row_entries`` lists the
    entries of each row (padded with ``nnz``, which reads a zero value) and
    ``row_cols`` their columns; ``col_entries`` and ``col_rows`` are the
    same for each column.  Both tables sum their entries in one fixed
    order, so a product and its VJP give the same bits on every run.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    row_entries: torch.Tensor
    row_cols: torch.Tensor
    col_entries: torch.Tensor
    col_rows: torch.Tensor
    shape: Tuple[int, int]

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, shape, torch_device) -> "SparsePattern":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        row_entries = entry_table(rows, shape[0])
        col_entries = entry_table(cols, shape[1])

        def tensor(a):
            return torch.as_tensor(a, device=torch_device)

        return SparsePattern(
            rows=tensor(rows),
            cols=tensor(cols),
            row_entries=tensor(row_entries),
            row_cols=tensor(np.append(cols, 0)[row_entries]),
            col_entries=tensor(col_entries),
            col_rows=tensor(np.append(rows, 0)[col_entries]),
            shape=(int(shape[0]), int(shape[1])),
        )

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


def _padded(vals: torch.Tensor) -> torch.Tensor:
    return torch.cat([vals, vals.new_zeros(1)])


class SparseMatvec(torch.autograd.Function):
    """``y[..., i] = sum_k vals[k] x[..., cols[k]]`` over the entries of
    row ``i`` of ``pattern``: ``x`` of shape ``(..., n_cols)``, ``y`` of
    shape ``(..., n_rows)``.

    VJP: ``x_bar[..., c] = sum_k vals[k] y_bar[..., rows[k]]`` over the
    entries of column ``c`` (the transposed gather form), and
    ``vals_bar[k] = sum y_bar[..., rows[k]] x[..., cols[k]]`` over the
    leading dimensions (a gather of both).
    """

    @staticmethod
    def forward(ctx, vals, x, pattern: SparsePattern):
        ctx.pattern = pattern
        ctx.save_for_backward(vals, x)
        weights = _padded(vals)[pattern.row_entries]
        return torch.sum(weights * x[..., pattern.row_cols], dim=-1)

    @staticmethod
    @once_differentiable
    @_highest_precision
    def backward(ctx, grad):
        pattern = ctx.pattern
        vals, x = ctx.saved_tensors
        grad_vals = grad_x = None
        if ctx.needs_input_grad[0]:
            per_entry = grad[..., pattern.rows] * x[..., pattern.cols]
            grad_vals = per_entry.reshape(-1, pattern.nnz).sum(dim=0)
        if ctx.needs_input_grad[1]:
            weights = _padded(vals)[pattern.col_entries]
            grad_x = torch.sum(weights * grad[..., pattern.col_rows], dim=-1)
        return grad_vals, grad_x, None


@dataclass
class FactoredSystem:
    """A film's system ``A`` restricted to ``index`` (rows and columns),
    LU-factorized outside the graph: ``lu, perm`` from
    :func:`ops.linalg.factor_system` (the factors of ``-A[index, index]``)
    and ``inverse_perm``.  ``A`` is kept only for a float32 system, whose
    solves are refined against it (:func:`ops.linalg.lu_solve_refined`,
    residuals in float64 through ``residual_f64``)."""

    index: torch.Tensor
    n: int
    lu: torch.Tensor
    perm: torch.Tensor
    inverse_perm: torch.Tensor
    A: Optional[torch.Tensor] = None

    @staticmethod
    def factor(A: torch.Tensor, index: torch.Tensor, n: int) -> "FactoredSystem":
        lu, perm = linalg.factor_system(A)
        return FactoredSystem(
            index=index,
            n=n,
            lu=lu,
            perm=perm,
            inverse_perm=torch.argsort(perm),
            A=A if A.dtype == torch.float32 else None,
        )

    def _place(self, x: torch.Tensor) -> torch.Tensor:
        """``(ni, B)`` values at ``index`` as ``(B, n)`` rows, zero
        elsewhere."""
        out = x.new_zeros((x.shape[1], self.n))
        out[:, self.index] = x.T
        return out

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """``x = (-A)^-1 rhs[:, index]`` for ``rhs`` of shape ``(B, n)``,
        returned as ``(B, n)``, zero outside ``index``."""
        h = rhs[:, self.index].T
        if self.A is None:
            x = linalg.lu_solve((self.lu, self.perm), h)
        else:
            x = linalg.lu_solve_refined(self.A, (self.lu, self.perm), h)
        return self._place(x)

    def solve_transposed(self, rhs: torch.Tensor) -> torch.Tensor:
        """``(-A)^-T rhs[:, index]`` from the same packed LU: with
        ``(-A)[perm] = L U``, ``(-A)^T = U^T L^T P``, so two triangular
        solves on ``lu.mT`` and the inverse permutation."""
        y = torch.linalg.solve_triangular(self.lu.mT, rhs[:, self.index].T, upper=False)
        z = torch.linalg.solve_triangular(self.lu.mT, y, upper=True, unitriangular=True)
        return self._place(z[self.inverse_perm])


class BrandtSolve(torch.autograd.Function):
    """``x = (-A)^-1 rhs`` on a :class:`FactoredSystem`'s index set, where
    ``A = dense + S(vals)`` and ``S`` is the sparse part through which
    Lambda enters (``pattern``).  ``rhs`` and ``x`` are ``(B, n)`` rows, ``x``
    zero outside the index set; ``system`` is a cache made from ``vals``
    outside the graph.

    VJP: ``lam = (-A)^-T x_bar`` (one transposed solve against the same
    LU), ``rhs_bar = lam`` and, since ``d x = (-A)^-1 dA x``,
    ``vals_bar[k] = sum_b lam[b, rows[k]] x[b, cols[k]]``, which is zero
    for entries outside the index set.  Nothing of size ``(n, n)`` is
    returned.
    """

    @staticmethod
    def forward(ctx, rhs, vals, system: FactoredSystem, pattern: SparsePattern):
        x = system.solve(rhs)
        ctx.system, ctx.pattern = system, pattern
        ctx.save_for_backward(x)
        return x

    @staticmethod
    @once_differentiable
    @_highest_precision
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        pattern = ctx.pattern
        lam = ctx.system.solve_transposed(grad)
        grad_vals = None
        if ctx.needs_input_grad[1]:
            grad_vals = torch.sum(lam[:, pattern.rows] * x[:, pattern.cols], dim=0)
        return lam, grad_vals, None, None


class BiotSavartCoupling(torch.autograd.Function):
    """The field at ``dst_sites`` of the sheet current ``J`` ``(B, n1, 2)``
    at ``src_sites`` with areas ``src_areas``, squared height difference
    ``dz2``: :func:`ops.kernels.biot_savart_film_to_film_dz2`, i.e. the
    ``biot_savart_batch`` kernel on the card.  Returns ``(B, n2)``.

    With ``K(src, a, J, dst)[b, i] = (1/4pi) sum_j a_j (dy_ij Jx[b, j] -
    dx_ij Jy[b, j]) / r_ij^3`` and ``d = dst - src``, swapping the roles
    flips the sign of ``d``, so the VJP is the same sum:
    ``Jx_bar[b, j] = -a_j K(dst, 1, (g_bar_b, 0), src)[b, j]`` and
    ``Jy_bar[b, j] = -a_j K(dst, 1, (0, g_bar_b), src)[b, j]``, both from one
    launch of ``2B`` columns with the same ``dz2``.  The geometry gets no
    gradient.
    """

    @staticmethod
    def forward(ctx, J, src_sites, src_areas, dst_sites, dz2: float):
        ctx.save_for_backward(src_sites, src_areas, dst_sites)
        ctx.dz2 = dz2
        return kernels.biot_savart_film_to_film_dz2(src_sites, src_areas, J, dst_sites, dz2)

    @staticmethod
    @once_differentiable
    @_highest_precision
    def backward(ctx, grad):
        src_sites, src_areas, dst_sites = ctx.saved_tensors
        B = grad.shape[0]
        zero = torch.zeros_like(grad)
        probe = torch.stack([torch.cat([grad, zero]), torch.cat([zero, grad])], dim=-1)
        ones = torch.ones(dst_sites.shape[0], dtype=grad.dtype, device=grad.device)
        out = kernels.biot_savart_film_to_film_dz2(dst_sites, ones, probe, src_sites, ctx.dz2)
        grad_J = -src_areas[None, :, None] * torch.stack([out[:B], out[B:]], dim=-1)
        return grad_J, None, None, None, None


class DenseProduct(torch.autograd.Function):
    """``y = x @ W.T`` for a constant ``W`` ``(m, n)`` and ``x`` ``(B, n)``;
    VJP ``x_bar = y_bar @ W``."""

    @staticmethod
    def forward(ctx, x, W):
        ctx.save_for_backward(W)
        return x @ W.T

    @staticmethod
    @once_differentiable
    @_highest_precision
    def backward(ctx, grad):
        (W,) = ctx.saved_tensors
        return grad @ W, None


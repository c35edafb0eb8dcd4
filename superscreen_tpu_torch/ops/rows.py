"""Matrices split by rows over the model slots of a device mesh, and the
explicit inverse of a row-sharded SPD system.

A :class:`RowSharded` holds one row block per slot, each on its slot's
device.  Its products run slot by slot, each on its own device, and the
rows are gathered on the device of the right-hand side.  The one way a
block reaches another slot is :func:`_send` (``.to(device)``, which
returns the tensor itself where it is already there: on a device that
repeats in the mesh the blocks are views of one matrix and cost nothing).
The container knows nothing of meshes: :mod:`superscreen_tpu_torch.parallel`
places its blocks.

The explicit inverse (:func:`schur_inverse_rows`,
:func:`schulz_inverse_rows`) is that of ``P_s``, the symmetric part of
``P = sign * A diag(1/w)``, built in :data:`PEAK_BLOCKS` row-sharded
matrices per slot, the caller's system ``A`` among them: ``A``, the
iterate ``X`` and the next iterate of a Schulz-Hotelling step.  ``P`` is
never stored.  ``X`` starts as a scaled copy of ``A``, symmetrised in
place piece by piece; Gauss-Jordan elimination inverts it in place over
pivot panels within one slot's rows; a product with ``P_s`` is formed
from ``A`` and its transpose, one column panel of at most :data:`PANEL`
columns at a time (:func:`_sym_panel`).  Beyond its blocks a slot holds
a few ``(n, PANEL)`` panels and one Gauss-Jordan pivot panel of at most
:data:`SCHUR_LEAF` rows.  This is the port's counterpart of the JAX
package's GSPMD program with its output pinned row-sharded
(``superscreen_tpu/parallel/sharding.py`` ``sharded_spd_inverse``).  Its
products are plain ``torch`` matrix products, as the JAX package's are
plain XLA ones; the caller keeps TF32 off.
"""

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels

__all__ = [
    "RowSharded",
    "row_bounds",
    "schur_inverse_rows",
    "schulz_inverse_rows",
    "PEAK_BLOCKS",
    "PANEL",
    "SCHULZ_ITERS",
    "SCHUR_LEAF",
]

#: Schulz-Hotelling iterations of the ``"schulz"`` inverse, as in the JAX
#: package (``SUPERSCREEN_TPU_SCHULZ_ITERS``, default 24).
SCHULZ_ITERS = int(os.environ.get("SUPERSCREEN_TPU_SCHULZ_ITERS", "24"))

#: Largest pivot panel of the ``"schur"`` inverse: the JAX package's leaf.
SCHUR_LEAF = 2048

#: Columns of one panel of a product with ``P_s``, and the side of one
#: piece of the in-place symmetrisation (at most a slot's rows).
PANEL = 2048

#: Row-sharded ``n x n`` matrices a slot holds at the peak of the explicit
#: inverse, the caller's system included: ``A``, ``X`` and the next ``X``.
PEAK_BLOCKS = 3


def row_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """``parts`` contiguous ranges of ``n`` rows, as ``torch.tensor_split``
    cuts them: the first ``n % parts`` one row longer than the rest (some
    empty where ``n < parts``)."""
    q, r = divmod(n, parts)
    bounds, lo = [], 0
    for i in range(parts):
        hi = lo + q + (1 if i < r else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: the only copy between slots (a no-op on the
    same device)."""
    return t.to(device)


class RowSharded:
    """A matrix split by rows over the model slots of one data row.

    Args:
        blocks: One ``(rows_i, n)`` tensor per slot, on that slot's
            device, in row order (a block may have no rows).

    ``shape`` and ``dtype`` are the whole matrix's; ``bounds[i]`` are the
    rows of block ``i``.  ``np.asarray`` gathers it to the host and
    :meth:`to_dense` to one device.
    """

    ndim = 2

    def __init__(self, blocks: Sequence[torch.Tensor]):
        blocks = list(blocks)
        if not blocks:
            raise ValueError("RowSharded needs at least one block.")
        cols = {b.shape[1] for b in blocks}
        dtypes = {b.dtype for b in blocks}
        if len(cols) != 1 or len(dtypes) != 1 or any(b.ndim != 2 for b in blocks):
            raise ValueError("The blocks must be 2-d with one column count and one dtype.")
        self.blocks = blocks
        self.bounds = []
        lo = 0
        for b in blocks:
            self.bounds.append((lo, lo + b.shape[0]))
            lo += b.shape[0]
        self.shape = (lo, cols.pop())
        self.dtype = dtypes.pop()

    @classmethod
    def split(cls, A: torch.Tensor, devices: Sequence) -> "RowSharded":
        """``A`` split into ``len(devices)`` row blocks (:func:`row_bounds`),
        block ``i`` on ``devices[i]``; on ``A``'s own device a block is a
        view of ``A``."""
        return cls([_send(A[lo:hi], d) for (lo, hi), d in zip(row_bounds(A.shape[0], len(devices)), devices)])

    @property
    def device(self) -> torch.device:
        """The device of the first block."""
        return self.blocks[0].device

    def reshard(self, devices: Sequence) -> "RowSharded":
        """The same matrix over ``devices`` (:func:`row_bounds` blocks),
        each new block assembled from the pieces of the old ones it
        overlaps: no slot receives more than its own rows."""
        new = row_bounds(self.shape[0], len(devices))
        if new == self.bounds:
            return RowSharded([_send(b, d) for b, d in zip(self.blocks, devices)])
        blocks = []
        for (lo, hi), d in zip(new, devices):
            pieces = [
                _send(b[max(lo, a) - a : min(hi, z) - a], d)
                for b, (a, z) in zip(self.blocks, self.bounds)
                if min(hi, z) > max(lo, a)
            ]
            blocks.append(
                torch.cat(pieces) if pieces
                else torch.empty((0, self.shape[1]), dtype=self.dtype, device=d)
            )
        return RowSharded(blocks)

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([b.detach().cpu().numpy() for b in self.blocks])
        return out if dtype is None else out.astype(dtype)

    def to_dense(self, device=None) -> torch.Tensor:
        """The whole matrix on ``device`` (default: the first block's)."""
        device = self.device if device is None else device
        return torch.cat([_send(b, device) for b in self.blocks])

    def take_rows(self, rows) -> torch.Tensor:
        """Rows ``rows`` (sorted indices) of the matrix, on the first
        block's device."""
        rows = torch.as_tensor(rows).cpu()
        parts = []
        for b, (lo, hi) in zip(self.blocks, self.bounds):
            mine = rows[(rows >= lo) & (rows < hi)] - lo
            if len(mine):
                parts.append(_send(b[mine.to(b.device)], self.device))
        return torch.cat(parts)

    def residual_f64(
        self, X: torch.Tensor, H: Optional[torch.Tensor] = None, *,
        out_dtype: torch.dtype = torch.float64,
    ) -> torch.Tensor:
        """:func:`ops.kernels.residual_f64` ``H + A X`` of a float32
        matrix, one call per non-empty block on its slot's device (``X``
        as it is, ``H`` by rows), the rows gathered on ``X``'s device."""
        parts = []
        for b, (lo, hi) in zip(self.blocks, self.bounds):
            if hi == lo:
                continue
            Hb = None if H is None else _send(H[lo:hi], b.device)
            R = kernels.residual_f64(b, _send(X, b.device), Hb, out_dtype=out_dtype)
            parts.append(_send(R, X.device))
        return torch.cat(parts)

    def matmul(self, X: torch.Tensor) -> torch.Tensor:
        """``A @ X`` for ``X`` ``(n,)`` or ``(n, k)``: one product per
        non-empty block on its slot's device, the rows gathered on ``X``'s
        device."""
        parts = [
            _send(b @ _send(X, b.device), X.device)
            for b, (lo, hi) in zip(self.blocks, self.bounds)
            if hi > lo
        ]
        return torch.cat(parts)

    __matmul__ = matmul

    def __repr__(self) -> str:
        rows = [hi - lo for lo, hi in self.bounds]
        devices = [str(b.device) for b in self.blocks]
        return f"RowSharded(shape={self.shape}, dtype={self.dtype}, rows={rows}, devices={devices})"


def _panel_width(X: RowSharded) -> int:
    """:data:`PANEL`, cut to the rows of the largest block so that a panel
    never outgrows a slot's rows."""
    return max(1, min(PANEL, max(hi - lo for lo, hi in X.bounds)))


def _sym_panel(A: RowSharded, inv_w: torch.Tensor, sign: float, parts: List[torch.Tensor]):
    """Row blocks of ``P_s V`` for a column panel ``V`` given by its row
    blocks (``parts[i]`` on slot ``i``): ``P_s V = sign / 2 (A (V / w) +
    (A^T V) / w)``.  Slot ``j`` forms ``A_j^T V_j``; slot ``i`` adds the
    ``i`` rows of each and multiplies its rows of ``A`` by the gathered
    ``V / w``.  Nothing of size ``n x n`` is formed."""
    scaled = [p * _send(inv_w[lo:hi], p.device)[:, None] for p, (lo, hi) in zip(parts, A.bounds)]
    AtV = [b.T @ p for b, p in zip(A.blocks, parts)]
    out = []
    for b, (lo, hi) in zip(A.blocks, A.bounds):
        y = torch.zeros((hi - lo, parts[0].shape[1]), dtype=b.dtype, device=b.device)
        for t in AtV:
            y += _send(t[lo:hi], b.device)
        y *= _send(inv_w[lo:hi], b.device)[:, None]
        y.addmm_(b, torch.cat([_send(s, b.device) for s in scaled]))
        out.append(y.mul_(0.5 * sign))
    return out


def _sym_matvec(A: RowSharded, inv_w: torch.Tensor, sign: float, v: torch.Tensor) -> torch.Tensor:
    """``P_s v`` for ``v`` ``(n,)``, gathered on ``v``'s device."""
    parts = [_send(v[lo:hi, None], b.device) for b, (lo, hi) in zip(A.blocks, A.bounds)]
    return torch.cat([_send(y, v.device) for y in _sym_panel(A, inv_w, sign, parts)])[:, 0]


def _symmetrize_(X: RowSharded) -> None:
    """``X <- (X + X^T) / 2`` in place, over pieces of at most
    :func:`_panel_width` rows and columns, each within one slot's rows: a
    piece and its mirror are averaged on the piece's slot and the mirror
    is sent back, so a slot receives at most one piece at a time."""
    width = _panel_width(X)
    chunks = [
        (i, lo, min(lo + width, z)) for i, (a, z) in enumerate(X.bounds) for lo in range(a, z, width)
    ]
    for k, (i, p0, p1) in enumerate(chunks):
        Xi, ai = X.blocks[i], X.bounds[i][0]
        for j, q0, q1 in chunks[k:]:
            Xj, aj = X.blocks[j], X.bounds[j][0]
            upper = Xi[p0 - ai : p1 - ai, q0:q1]
            lower = Xj[q0 - aj : q1 - aj, p0:p1]
            S = (upper + _send(lower, Xi.device).T).mul_(0.5)
            upper.copy_(S)
            lower.copy_(_send(S, Xj.device).T)


def _leaf_spd_inverse(D: torch.Tensor) -> torch.Tensor:
    """Inverse of a small SPD block: Cholesky, a triangular solve against
    the identity, then ``L^-T L^-1`` (the JAX package's leaf)."""
    L = torch.linalg.cholesky(D)
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L_inv.T @ L_inv


def _gauss_jordan_inverse_(X: RowSharded, leaf: int) -> None:
    """Inverts an SPD row-sharded ``X`` in place by block Gauss-Jordan
    elimination over pivot panels of at most ``leaf`` rows, each within
    one slot's rows.  A step inverts the pivot block of the current Schur
    complement (:func:`_leaf_spd_inverse`), forms the pivot panel ``R =
    D^-1 X[K, :]`` on the owner's device (with ``D^-1`` in its own
    columns), sends it to every slot, and each slot updates its rows:
    ``X[I, :] -= X[I, K] R`` with ``X[I, K]`` zeroed first, which leaves
    ``-X[I, K] D^-1`` there; the pivot rows become ``R``.  After the last
    panel the rows hold ``X^-1``.  These are the successive Schur
    complements of the JAX package's recursive 2 x 2 Schur inverse, one
    leading panel at a time."""
    for owner, (lo, hi) in zip(X.blocks, X.bounds):
        for k0 in range(lo, hi, leaf):
            k1 = min(k0 + leaf, hi)
            D_inv = _leaf_spd_inverse(owner[k0 - lo : k1 - lo, k0:k1])
            R = D_inv @ owner[k0 - lo : k1 - lo]
            R[:, k0:k1] = D_inv
            for rows in X.blocks:
                if not rows.shape[0]:
                    continue
                c = rows[:, k0:k1].clone()
                rows[:, k0:k1] = 0
                rows.addmm_(c, _send(R, rows.device), alpha=-1)
            owner[k0 - lo : k1 - lo] = R


def _schulz_step(A: RowSharded, inv_w: torch.Tensor, sign: float, X: RowSharded) -> RowSharded:
    """One Schulz-Hotelling step ``X (2I - P_s X) = 2X - X (P_s X)``, one
    column panel at a time into new blocks (every panel reads the whole
    of ``X``, so ``X`` is not overwritten)."""
    new = [torch.empty_like(b) for b in X.blocks]
    n, width = X.shape[1], _panel_width(X)
    for c0 in range(0, n, width):
        c1 = min(c0 + width, n)
        Z = _sym_panel(A, inv_w, sign, [b[:, c0:c1] for b in X.blocks])
        for rows, out in zip(X.blocks, new):
            if rows.shape[0]:
                W = rows @ torch.cat([_send(z, rows.device) for z in Z])
                out[:, c0:c1] = W.neg_().add_(rows[:, c0:c1], alpha=2.0)
                del W
        del Z  # before the next panel's
    return RowSharded(new)


def _solution_operator_(X: RowSharded, w: torch.Tensor) -> RowSharded:
    """``M = -X / w`` (rows scaled) in place: for ``X = P_s^-1``, ``x = M
    h`` solves ``(-A) x = h`` where ``A = sign * P diag(w)``."""
    for rows, (lo, hi) in zip(X.blocks, X.bounds):
        rows.div_(_send(w[lo:hi], rows.device)[:, None]).neg_()
    return X


def schur_inverse_rows(
    A: RowSharded, w: torch.Tensor, sign: float = 1.0, leaf: int = SCHUR_LEAF
) -> RowSharded:
    """The solution operator ``M`` of ``(-S) x = h`` by the ``"schur"``
    method, row-sharded like ``A``, for the system ``S = sign * A`` (``A``
    the system, or with ``sign = -1`` its negation; ``P = S / w`` is SPD
    up to its antisymmetric part): the port of the JAX package's
    ``_schur_inverse_body``.  ``P_s`` is inverted in place by
    :func:`_gauss_jordan_inverse_` and the inverse takes one
    Schulz-Hotelling correction against ``P_s``.  The JAX body pads ``P``
    with an identity block to a multiple of its leaf; here a pivot panel
    may be shorter than ``leaf``, so nothing is padded.  ``A`` is only
    read."""
    inv_w = 1.0 / w
    X = RowSharded([(b * _send(inv_w, b.device)[None, :]).mul_(sign) for b in A.blocks])
    _symmetrize_(X)
    _gauss_jordan_inverse_(X, max(1, int(leaf)))
    return _solution_operator_(_schulz_step(A, inv_w, sign, X), w)


def schulz_inverse_rows(
    A: RowSharded, w: torch.Tensor, sign: float = 1.0, iters: Optional[int] = None
) -> RowSharded:
    """The solution operator ``M`` (as :func:`schur_inverse_rows`) by the
    ``"schulz"`` method: the port of the JAX package's
    ``_jax_spd_inverse``.  ``lambda_max`` of ``P_s`` is estimated by 25
    power iterations from the normalised ones vector, and ``iters``
    (default :data:`SCHULZ_ITERS`) Schulz-Hotelling steps run from ``X =
    I / (1.05 lambda_max)``."""
    iters = SCHULZ_ITERS if iters is None else iters
    inv_w = 1.0 / w
    n = A.shape[0]
    v = torch.ones(n, dtype=A.dtype, device=A.device) / np.sqrt(n)
    for _ in range(25):
        v = _sym_matvec(A, inv_w, sign, v)
        v = v / torch.linalg.vector_norm(v)
    lam = v @ _sym_matvec(A, inv_w, sign, v)

    def start(b, lo, hi):
        X0 = torch.zeros_like(b)
        X0[:, lo:hi] = torch.eye(hi - lo, dtype=b.dtype, device=b.device)
        return X0.div_(_send(1.05 * lam, b.device))

    # Only X is left referencing the start, so each step frees it.
    X = RowSharded([start(b, lo, hi) for b, (lo, hi) in zip(A.blocks, A.bounds)])
    for _ in range(iters):
        X = _schulz_step(A, inv_w, sign, X)
    return _solution_operator_(X, w)

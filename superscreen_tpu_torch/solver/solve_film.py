"""Per-film linear systems.

Counterpart of ``superscreen_tpu/solver/solve_film.py``: each film's system
``A = Q diag(w) - Lambda laplacian`` is restricted to the film's interior
(outside its holes) and factorized on the torch device by
:func:`ops.linalg.factor_system` with the film's interior weights: LU on
the CPU and up to ``LU_MAX_N_TPU`` unknowns, above that on the card the
route of ``SUPERSCREEN_TPU_LARGE_FACTOR`` (the explicit inverse by
default), as the JAX package factorizes on its accelerator.  A film with
an inhomogeneous Lambda has no symmetric positive definite scaling, and
the routes' symmetric part misses the residual bar
(``tests/test_torch_factor_routes.py``): on the card above
``LU_MAX_N_TPU`` it is inverted from its LU instead, elsewhere
LU-factorized.  Each hole gets the all-rows, hole-columns system whose row
sums give the effective field of a unit circulating current.

A film on the low-memory path (``FilmInfo.dense_kernel`` False) never
builds the full ``(n, n)`` kernel.  Its interior system is assembled from
the q-block of the interior sites, the matrix-free row sums ``q @ w`` and
the sparse Laplacian, and is factorized as a dense film's is; or, with
``SUPERSCREEN_TPU_LARGE_FACTOR=cg`` or an interior above the materialized
ceiling, it is not materialized at all and is solved on the matrix-free
operator: by CG, or by BiCGStab when its Lambda is inhomogeneous.  Its
hole systems are the row-sum vectors themselves.  With a factorization
mesh installed (:func:`superscreen_tpu_torch.parallel.set_factorization_mesh`)
the ceiling rises by ``sqrt(n_model)``, and a film past the single-device
ceiling is assembled straight into row blocks over the mesh's model slots
(each slot's block of ``q`` from the ``q_matrix`` kernel's rectangular
entry) and inverted there: its factors are ``("inv", M, w)``.

An inhomogeneous Lambda adds the ``(grad Lambda) . grad`` term to every
system: a dense block on the dense path, COO triplets folded into the
Laplacian's on the low-memory path.

A film with transport terminals gets :class:`TerminalSystems`, whose
interior block doubles as the film's main system, and its transport
stream from :func:`solve_for_terminal_current_stream`.

:func:`solve_film` solves one film for one drive on these systems, on the
torch device that holds them, and returns its :class:`FilmSolution`.
"""

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import Device
from ..io import new_group
from ..ops import kernels, linalg
from ..ops.fem import COO, gather_matvec
from ..ops.rows import PEAK_BLOCKS, RowSharded, row_bounds
from ..parallel import sharding
from ..solution import FilmSolution
from .utils import FilmInfo, stream_from_terminal_current

__all__ = [
    "MAX_MATERIALIZED_BYTES",
    "LinearSystem",
    "TerminalSystems",
    "factorize_linear_systems",
    "max_materialized_n",
    "solve_for_terminal_current_stream",
    "terminal_boundary_stream",
    "boundary_stream_from_indices",
    "solve_from_boundary_stream",
    "solve_film",
    "permutation_to_pivots",
    "pivots_to_permutation",
]

#: Device bytes one low-memory film's factorization may take at its peak;
#: sets the default ceiling on the interior size ``ni`` of a film whose
#: system is materialized and factorized (a larger interior is solved by
#: CG matrix-free).  At that peak the card holds :data:`LU_PEAK_BUFFERS`
#: ``(ni, ni)`` buffers: for LU ``A``, the transient ``-A`` that
#: :func:`ops.linalg.factor_system` hands to ``lu_factor`` and the packed
#: ``LU`` (12.0 bytes per ni^2 in float32 as measured on an H100); for the
#: ``"inv"`` and ``"chol"`` routes and the inverse from LU fewer, ``A``
#: and the one buffer the factor is built in, plus panels (2.25 and 2.12
#: on an H100 at ni = 16,768 for ``"inv"`` and ``"chol"``).  The
#: ``"schur"`` and ``"schulz"`` routes hold :data:`INVERSE_PEAK_BUFFERS`.  67.5 GB of an 80 GB card, which leaves
#: ~12 GB for the solver's workspace and the model's other tensors, gives
#: ni = 75,000 in float32 and 53,033 in float64 at three buffers.  The JAX
#: package's default, 65,000, was sized for a 16 GB TPU with another
#: factorization.
#: ``SUPERSCREEN_TPU_MAX_MATERIALIZED_N`` (read when the model is
#: factorized) sets the ceiling directly.
MAX_MATERIALIZED_BYTES = 67_500_000_000

#: ``(ni, ni)`` buffers at the peak of a single-device factorization, which
#: :data:`MAX_MATERIALIZED_BYTES` is sized for.
LU_PEAK_BUFFERS = 3

#: ``(ni, ni)`` buffers at the peak of the ``"schur"`` and ``"schulz"``
#: routes on one card: ``A``, the iterate and the next
#: (:data:`ops.rows.PEAK_BLOCKS`) and the panels of a product with the
#: symmetrised system, which stay below one more matrix above
#: ``ops.linalg.LU_MAX_N_TPU`` (3.49 on an H100 at ni = 16,768, 3.66 at
#: 12,430).  Their materialized ceiling derives from it.
INVERSE_PEAK_BUFFERS = PEAK_BLOCKS + 1


@dataclass
class LinearSystem:
    """The linear system for a film or hole.

    Args:
        A: The matrix ``Q diag(w) - Lambda laplacian - (grad Lambda) .
            grad`` restricted to ``indices`` (rows and columns for a film,
            columns for a hole or a boundary).
            For a hole of a low-memory film, the vector ``A @ 1``.  None
            for a film solved matrix-free.
        indices: The mesh indices this system acts on.
        lu_piv: The factors of ``-A`` (see
            :func:`superscreen_tpu_torch.ops.linalg.factor_system`): LU
            ``(LU, perm)``, the explicit inverse ``("inv", M, w)`` (``A``
            and ``M`` row-sharded for a film factorized over a mesh; ``w``
            None for a film inverted from its LU), or
            the Cholesky factor ``("chol", L, w)``; or None.
        cg_op: The matrix-free operator pieces of a film solved by CG (see
            :func:`superscreen_tpu_torch.ops.linalg.brandt_matvec`), or None.
    """

    A: Optional[torch.Tensor]
    indices: np.ndarray
    lu_piv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    cg_op: Optional[Dict[str, torch.Tensor]] = None

    def to_hdf5(self, h5group) -> None:
        """Writes the system into ``h5group`` (an ``h5py.Group``) in the JAX
        package's layout: ``A``, ``indices``, and the factors as ``lu`` and
        0-based LAPACK ``piv`` (the JAX package's convention), ``inv_M``
        and ``inv_w`` (a row-sharded ``M`` gathered; no ``inv_w`` for an
        inverse from LU, which has no scaling), or ``chol_L`` and
        ``chol_w``; the matrix-free pieces of a film solved by CG or
        BiCGStab go to a ``matrix_free`` group of this package's own.  The
        tensors come to the host here."""
        if self.A is not None:
            h5group["A"] = np.asarray(self.A.cpu() if torch.is_tensor(self.A) else self.A)
        h5group["indices"] = np.asarray(self.indices)
        kind = None if self.lu_piv is None else linalg.factor_kind(self.lu_piv)
        if kind in ("inv", "chol"):
            _, factor, w = self.lu_piv
            name = "inv_M" if kind == "inv" else "chol_L"
            h5group[name] = np.asarray(factor.cpu() if torch.is_tensor(factor) else factor)
            if w is not None:
                h5group[f"{kind}_w"] = w.cpu().numpy()
        elif kind == "lu":
            lu, perm = self.lu_piv
            h5group["lu"] = lu.cpu().numpy()
            h5group["piv"] = permutation_to_pivots(perm.cpu().numpy())
        if self.cg_op is not None:
            grp = new_group(h5group, "matrix_free")
            for key, value in self.cg_op.items():
                if isinstance(value, torch.Tensor):
                    grp[key] = value.cpu().numpy()
                else:
                    grp.attrs[key] = value
        # The (grad Lambda) . grad term is part of A here.
        h5group.attrs["grad_Lambda_term"] = 0.0

    @staticmethod
    def from_hdf5(h5group, torch_device) -> "LinearSystem":
        """Reads a system written by :meth:`to_hdf5` or by the JAX package,
        with its tensors on ``torch_device``.

        A JAX low-memory film's system is padded with a decoupled identity
        block up to a multiple of 2048: ``A`` and the factors are cut back
        to ``len(indices)`` (partial pivoting never leaves the film's
        block, and the Cholesky factor and the inverse of a block-diagonal
        matrix are block-diagonal, so the cut factors are those of the
        film's system).  An ``"inv"`` film loads with ``M`` on
        ``torch_device``, a film inverted over a mesh too.  The JAX
        package's ``"cg"`` factorization, which this package does not
        load, raises ``NotImplementedError`` naming the tag.
        """
        if "cg_sub_sites" in h5group:
            raise NotImplementedError(
                "The system's 'cg' factorization of the JAX package has no "
                "counterpart here; refactorize the model with superscreen_tpu_torch."
            )
        indices = np.array(h5group["indices"])
        ni = len(indices)

        def tensor(array):
            return torch.as_tensor(np.ascontiguousarray(array), device=torch_device)

        A = np.array(h5group["A"]) if "A" in h5group else None
        lu_piv = None
        if "lu" in h5group:
            lu, piv = np.array(h5group["lu"]), np.array(h5group["piv"])
            A, lu, piv = A[:ni, :ni], lu[:ni, :ni], piv[:ni]
            # Column-major, as ``torch.linalg.lu_factor`` returns it: the
            # triangular solves then sum in the same order, to the bit.
            lu_piv = (tensor(lu.T).mT, tensor(pivots_to_permutation(piv)))
        for tag, key in (("inv", "inv_M"), ("chol", "chol_L")):
            if key in h5group:
                A = A[:ni, :ni]
                factor = np.array(h5group[key])[:ni, :ni]
                w = h5group.get(f"{tag}_w")
                lu_piv = (tag, tensor(factor), None if w is None else tensor(np.array(w)[:ni]))
        cg_op = None
        if "matrix_free" in h5group:
            grp = h5group["matrix_free"]
            cg_op = {key: tensor(np.array(value)) for key, value in grp.items()}
            cg_op.update({key: bool(value) for key, value in grp.attrs.items()})
        return LinearSystem(
            A=None if A is None else tensor(A), indices=indices, lu_piv=lu_piv, cg_op=cg_op
        )


@dataclass
class TerminalSystems:
    """The linear systems needed for the transport-current stream function
    of a film with terminals.

    Args:
        film: The film name.
        boundary: System for the film boundary (all rows, boundary columns).
        holes: ``{hole_name: system}`` systems for holes in the film.
        film_without_boundary: System for the film interior (incl. holes).
        film_without_boundary_or_holes: System for the film interior
            excluding holes (None if the film has no holes).
    """

    film: str
    boundary: LinearSystem
    holes: Dict[str, LinearSystem]
    film_without_boundary: LinearSystem
    film_without_boundary_or_holes: Optional[LinearSystem] = None

    def to_hdf5(self, h5group) -> None:
        """Writes the systems into ``h5group`` (an ``h5py.Group``)."""
        h5group.attrs["film"] = self.film
        self.boundary.to_hdf5(new_group(h5group, "boundary"))
        holes_grp = new_group(h5group, "holes")
        for name, system in self.holes.items():
            system.to_hdf5(new_group(holes_grp, name))
        self.film_without_boundary.to_hdf5(new_group(h5group, "film_without_boundary"))
        if self.film_without_boundary_or_holes is not None:
            self.film_without_boundary_or_holes.to_hdf5(
                new_group(h5group, "film_without_boundary_or_holes")
            )

    @staticmethod
    def from_hdf5(h5group, torch_device) -> "TerminalSystems":
        """Reads the systems written by :meth:`to_hdf5` or by the JAX
        package, with their tensors on ``torch_device``."""
        def load(grp):
            return LinearSystem.from_hdf5(grp, torch_device)

        rest = None
        if "film_without_boundary_or_holes" in h5group:
            rest = load(h5group["film_without_boundary_or_holes"])
        return TerminalSystems(
            film=str(h5group.attrs["film"]),
            boundary=load(h5group["boundary"]),
            holes={name: load(grp) for name, grp in h5group["holes"].items()},
            film_without_boundary=load(h5group["film_without_boundary"]),
            film_without_boundary_or_holes=rest,
        )


def permutation_to_pivots(perm: np.ndarray) -> np.ndarray:
    """The 0-based LAPACK pivots (row ``i`` swapped with row ``piv[i]``, in
    sequence) of the row permutation ``perm``; the inverse of
    :func:`pivots_to_permutation`.  The pivots with ``piv[i] >= i`` that
    produce a permutation are unique, so these are the ones
    ``lu_factor`` returned."""
    perm = np.asarray(perm, dtype=np.int64)
    rows = np.arange(len(perm))  # rows[k]: the original row now at k
    where = np.arange(len(perm))  # where[r]: the position of original row r
    piv = np.empty(len(perm), dtype=np.int32)
    for i, target in enumerate(perm):
        j = where[target]
        piv[i] = j
        rows[i], rows[j] = rows[j], rows[i]
        where[rows[i]], where[rows[j]] = i, j
    return piv


def pivots_to_permutation(piv: np.ndarray) -> np.ndarray:
    """The row permutation ``perm`` (``M[perm] = L U``) of 0-based LAPACK
    pivots, as :func:`superscreen_tpu_torch.ops.linalg.factor_system`
    keeps it."""
    perm = np.arange(len(piv))
    for i, j in enumerate(np.asarray(piv, dtype=np.int64)):
        perm[i], perm[j] = perm[j], perm[i]
    return perm


def _build_system_1d(Q, weights, Lambda, laplacian, ix, grad_Lambda_term=None):
    """The 'effective applied field' system: all rows, columns ``ix``.
    ``grad_Lambda_term`` is the dense ``(grad Lambda) . grad`` block of an
    inhomogeneous film, else None."""
    ix = torch.as_tensor(ix, device=Q.device)
    A = Q[:, ix] * weights[ix] - Lambda[ix] * laplacian[:, ix]
    if grad_Lambda_term is not None:
        A -= grad_Lambda_term[:, ix]
    return A


def _build_system_2d(Q, weights, Lambda, laplacian, ix, grad_Lambda_term=None):
    """The stream-function system restricted to rows and columns ``ix``."""
    ix = torch.as_tensor(ix, device=Q.device)
    rows, cols = ix[:, None], ix[None, :]
    A = Q[rows, cols] * weights[ix] - Lambda[ix] * laplacian[rows, cols]
    if grad_Lambda_term is not None:
        A -= grad_Lambda_term[rows, cols]
    return A


def _restricted_coo(op, pos: np.ndarray, value_scale: Optional[np.ndarray] = None):
    """Restricts a COO operator to the index set encoded by ``pos`` (global
    index -> restricted position, -1 outside), optionally scaling each kept
    value by ``value_scale[global_row]``.  Returns ``(rows, cols, vals)``."""
    keep = (pos[op.rows] >= 0) & (pos[op.cols] >= 0)
    rows_g = op.rows[keep]
    vals = op.vals[keep]
    if value_scale is not None:
        vals = vals * value_scale[rows_g]
    return pos[rows_g], pos[op.cols[keep]], vals


def _coo_matvec_host(op, x: np.ndarray) -> np.ndarray:
    """Host (NumPy) COO matvec."""
    return np.bincount(op.rows, weights=op.vals * x[op.cols], minlength=op.shape[0])


def _lowmem_grad_lambda_triplets(info: FilmInfo, ix: np.ndarray):
    """COO triplets, in the numbering of ``ix``, of the inhomogeneous-Lambda
    term ``(grad Lambda) . grad`` restricted to ``ix``:
    ``GL[i, j] = (gx @ Lambda)[i] gx[i, j] + (gy @ Lambda)[i] gy[i, j]``."""
    gx, gy = info.gradient_coo
    Lambda = np.asarray(info.lambda_info.Lambda[:, 0], dtype=float)
    pos = np.full(gx.shape[0], -1, dtype=np.int64)
    pos[ix] = np.arange(len(ix))
    parts = [
        _restricted_coo(op, pos, value_scale=_coo_matvec_host(op, Lambda)) for op in (gx, gy)
    ]
    return tuple(np.concatenate(axis) for axis in zip(*parts))


def _restricted_lambda_triplets(info: FilmInfo, ix: np.ndarray) -> COO:
    """The Lambda terms restricted to ``ix``, in the numbering of ``ix``, as
    a coalesced host COO operator in the solve dtype: the Laplacian with
    each column scaled by its Lambda plus, for an inhomogeneous film, the
    ``(grad Lambda) . grad`` term (both are subtracted from ``A``).  Entries
    that share a position are summed here, on the host, so that neither the
    scatter into ``A`` nor the gather form has duplicates."""
    lap = info.laplacian
    Lambda = info.lambda_info.Lambda[:, 0]
    pos = np.full(lap.shape[0], -1, dtype=np.int64)
    pos[ix] = np.arange(len(ix))
    keep = (pos[lap.rows] >= 0) & (pos[lap.cols] >= 0)
    rows, cols = pos[lap.rows[keep]], pos[lap.cols[keep]]
    vals = lap.vals[keep] * Lambda[lap.cols[keep]]
    if info.lambda_info.inhomogeneous:
        g_rows, g_cols, g_vals = _lowmem_grad_lambda_triplets(info, ix)
        rows = np.concatenate([rows, g_rows])
        cols = np.concatenate([cols, g_cols])
        vals = np.concatenate([vals, g_vals])
    op = COO(rows, cols, vals, (len(ix), len(ix))).coalesce()
    return COO(op.rows, op.cols, op.vals.astype(info.sites.dtype), op.shape)


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
    op = _restricted_lambda_triplets(info, ix)
    rows, cols, vals = (torch.as_tensor(a, device=sites.device) for a in (op.rows, op.cols, op.vals))
    return A.index_put_((rows, cols), -vals, accumulate=True)


def _build_system_2d_lowmem_rows(
    info: FilmInfo, ix: np.ndarray, sites: torch.Tensor, slots
) -> RowSharded:
    """:func:`_build_system_2d_lowmem` assembled straight into row blocks
    over the model slots ``slots``: slot ``j``'s block of ``q`` is
    ``q(sub[r0:r1], sub)`` from the ``q_matrix`` kernel's rectangular
    entry on its own device, its diagonal (column ``r0 + i`` of row
    ``i``) set from the matrix-free row sums, and the Laplacian triplets of
    its rows scattered in.  The full ``(ni, ni)`` system never lands on
    one slot; each block equals those rows of the unsharded system."""
    ix_t = torch.as_tensor(ix, device=sites.device)
    diag = _lowmem_diag(info, sites, ix_t)
    sub = sites[ix_t]
    w_sub = info.weights[ix_t]
    op = _restricted_lambda_triplets(info, ix)
    blocks = []
    for (r0, r1), slot in zip(row_bounds(len(ix), len(slots)), slots):
        block = kernels.q_matrix_rect(sub[r0:r1].to(slot), sub.to(slot))
        block.neg_()
        block[:, r0:r1].diagonal().copy_(diag[r0:r1])
        block.mul_(w_sub.to(slot)[None, :])
        mine = (op.rows >= r0) & (op.rows < r1)
        rows, cols, vals = (
            torch.as_tensor(a, device=slot)
            for a in (op.rows[mine] - r0, op.cols[mine], op.vals[mine])
        )
        blocks.append(block.index_put_((rows, cols), -vals, accumulate=True))
    return RowSharded(blocks)


def _lowmem_operator_pieces(info: FilmInfo, ix: np.ndarray, sites: torch.Tensor):
    """The matrix-free operator pieces of a low-memory film's interior
    system (see :func:`ops.linalg.brandt_matvec`); nothing of size
    ``(ni, ni)`` is built.  With an inhomogeneous Lambda the triplets carry
    the ``(grad Lambda) . grad`` term too and the operator is mildly
    non-symmetric: ``nonsym`` sends its solves to BiCGStab."""
    ix_t = torch.as_tensor(ix, device=sites.device)
    lap_idx, lap_w = _restricted_lambda_triplets(info, ix).to_gather(
        info.sites.dtype, sites.device
    )
    return {
        "sub_sites": sites[ix_t].contiguous(),
        "w_sub": info.weights[ix_t],
        "diag": _lowmem_diag(info, sites, ix_t),
        "lap_idx": lap_idx,
        "lap_w": lap_w,
        "nonsym": bool(info.lambda_info.inhomogeneous),
    }


def _hole_effective_field_vector_lowmem(
    info: FilmInfo, ix: np.ndarray, sites: torch.Tensor
) -> torch.Tensor:
    """A hole's ``A @ 1`` (the effective field of a unit circulating
    current) computed matrix-free:
    ``Q @ (w mask) - L @ (Lambda mask) - GL @ mask``."""
    w = info.weights
    mask = torch.zeros_like(w)
    mask[torch.as_tensor(ix, device=w.device)] = 1.0
    Lambda = torch.as_tensor(info.lambda_info.Lambda[:, 0], dtype=w.dtype, device=w.device)
    out = kernels.Q_apply(sites, w, w * mask) - info.laplacian.matvec(Lambda * mask)
    if info.lambda_info.inhomogeneous:
        for op in info.gradient_coo:
            out = out - op.matvec(Lambda) * op.matvec(mask)
    return out


def max_materialized_n(dtype: torch.dtype, buffers: int = LU_PEAK_BUFFERS) -> int:
    """The largest interior of a low-memory film that is materialized and
    factorized: ``SUPERSCREEN_TPU_MAX_MATERIALIZED_N`` if set, else what
    :data:`MAX_MATERIALIZED_BYTES` holds at ``buffers`` ``(ni, ni)``
    buffers of ``dtype``, the peak of the film's factorization route."""
    ceiling = os.environ.get("SUPERSCREEN_TPU_MAX_MATERIALIZED_N")
    if ceiling is not None:
        return int(ceiling)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return math.isqrt(MAX_MATERIALIZED_BYTES // (buffers * itemsize))


def _sharded_dense_ceiling(single_device_max: int) -> int:
    """The low-memory dense ceiling with a factorization mesh installed.
    A slot of the row-sharded inverse holds at its peak
    :data:`ops.rows.PEAK_BLOCKS` matrices of ``ni^2 / n_model`` entries
    each, the system among them, where one device holds
    :data:`LU_PEAK_BUFFERS` of ``ni^2``; the same bytes per slot give the
    ceiling ``single_device_max * sqrt(n_model * LU_PEAK_BUFFERS /
    PEAK_BLOCKS)``, the JAX package's ``sqrt(n_model)`` for the port's
    three.  Without a mesh whose model axis exceeds 1 the ceiling is the
    single-device one."""
    mesh = sharding.factorization_mesh()
    n_model = 1 if mesh is None else int(mesh.shape["model"])
    if n_model <= 1:
        return single_device_max
    return int(single_device_max * math.sqrt(n_model * LU_PEAK_BUFFERS / PEAK_BLOCKS))


def factorize_linear_systems(
    device: Device, film_info_dict: Dict[str, FilmInfo], assemble_only: bool = False
) -> Tuple[
    Dict[str, LinearSystem],
    Dict[str, Dict[str, LinearSystem]],
    Dict[str, TerminalSystems],
]:
    """Builds and factorizes the linear systems for all films, holes and
    terminals.

    Each film system is factorized by :func:`ops.linalg.factor_system`
    with its interior weights, or without them (LU, or on the card above
    ``ops.linalg.LU_MAX_N_TPU`` the inverse from LU) where the film's
    Lambda is inhomogeneous.  Each dense film's Laplacian (and gradient
    pair) is released once its systems are built.  A low-memory film is
    factorized from its materialized interior system, or, with
    ``SUPERSCREEN_TPU_LARGE_FACTOR=cg`` or an interior above
    ``SUPERSCREEN_TPU_MAX_MATERIALIZED_N``, left to a matrix-free solve.

    With ``assemble_only`` every system is materialized and none is
    factorized (``lu_piv`` stays None): the float64 assembly of a
    high-precision model, whose solves run on the float32 factors (see
    :mod:`superscreen_tpu_torch.solver.refine`).

    Returns:
        ``{film: film_system}``, ``{film: {hole: hole_system}}`` and
        ``{film: TerminalSystems}``.
    """
    method = linalg.large_factor_method()

    def factor(A, info, ix):
        if assemble_only:
            return None
        # The symmetric routes need the scaling that makes A / w symmetric
        # positive definite, which an inhomogeneous Lambda's term breaks.
        w_col = None
        if not info.lambda_info.inhomogeneous:
            w_col = info.weights[torch.as_tensor(ix, device=info.weights.device)]
        return linalg.factor_system(A, w_col)

    film_systems = {}
    hole_systems = {}
    terminal_systems = {}
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
            buffers = LU_PEAK_BUFFERS
            if (
                method in ("schur", "schulz")
                and not linalg._on_cpu(info.weights)
                and not info.lambda_info.inhomogeneous
            ):
                buffers = INVERSE_PEAK_BUFFERS
            single_device_max = max_materialized_n(info.weights.dtype, buffers)
            if not assemble_only and (
                method == "cg" or len(interior) > _sharded_dense_ceiling(single_device_max)
            ):
                film_systems[film_name] = LinearSystem(
                    A=None,
                    indices=interior,
                    cg_op=_lowmem_operator_pieces(info, interior, sites),
                )
            elif not assemble_only and len(interior) > single_device_max:
                # Dense only because the installed mesh's slots together
                # hold it: assembled and inverted row-sharded.
                mesh = sharding.factorization_mesh()
                A = _build_system_2d_lowmem_rows(info, interior, sites, list(mesh.devices[0]))
                w_col = info.weights[torch.as_tensor(interior, device=sites.device)]
                M = sharding.sharded_inverse_of_system(mesh, A, w_col)
                film_systems[film_name] = LinearSystem(
                    A=A, indices=interior, lu_piv=("inv", M, w_col)
                )
            else:
                A = _build_system_2d_lowmem(info, interior, sites)
                film_systems[film_name] = LinearSystem(
                    A=A, indices=interior, lu_piv=factor(A, info, interior)
                )
            continue
        Q, weights, laplacian = info.kernel, info.weights, info.laplacian
        Lambda = torch.as_tensor(
            info.lambda_info.Lambda[:, 0], dtype=Q.dtype, device=Q.device
        )
        grad_Lambda_term = None
        if info.lambda_info.inhomogeneous:
            # (grad Lambda) . grad as an operator:
            # diag(gx @ Lambda) @ gx + diag(gy @ Lambda) @ gy.
            gx, gy = info.gradient
            grad_Lambda_term = (gx @ Lambda)[:, None] * gx
            grad_Lambda_term.addcmul_((gy @ Lambda)[:, None], gy)

        def system_1d(indices):
            return LinearSystem(
                A=_build_system_1d(Q, weights, Lambda, laplacian, indices, grad_Lambda_term),
                indices=indices,
            )

        def system_2d(indices):
            A = _build_system_2d(Q, weights, Lambda, laplacian, indices, grad_Lambda_term)
            return LinearSystem(A=A, indices=indices, lu_piv=factor(A, info, indices))

        hole_systems[film_name] = {
            hole_name: system_1d(indices) for hole_name, indices in info.hole_indices.items()
        }
        if film_name in device.terminals:
            # The film's main system (its sites outside the holes and off
            # the boundary) is the terminal block's interior system:
            # ``info.interior_indices`` already excludes the boundary, so
            # that factorization is built once and shared.
            terminal_systems[film_name] = TerminalSystems(
                film=film_name,
                boundary=system_1d(info.boundary_indices),
                holes=hole_systems[film_name],
                film_without_boundary=system_2d(info.interior_indices),
                film_without_boundary_or_holes=(
                    system_2d(interior) if info.hole_indices else None
                ),
            )
            ts = terminal_systems[film_name]
            film_systems[film_name] = (
                ts.film_without_boundary_or_holes
                if info.hole_indices
                else ts.film_without_boundary
            )
        else:
            film_systems[film_name] = system_2d(interior)
        info.laplacian = None
        info.gradient = None
    return film_systems, hole_systems, terminal_systems


def solve_for_terminal_current_stream(
    device: Device,
    film_info: FilmInfo,
    terminal_systems: TerminalSystems,
    terminal_currents: Dict[str, float],
    hp_system=None,
) -> np.ndarray:
    """Stream function from transport currents in a single film, ``(n,)``
    on the host.

    1. Set the boundary stream from the terminal currents and solve in the
       film ignoring holes.
    2. Set each hole's stream to the weighted average from step 1.
    3. Re-solve with the hole boundary conditions.

    The drive enters through an affine map: the raw boundary stream is
    linear in the terminal currents (:func:`terminal_boundary_stream`), the
    centering shifts it by the drive-dependent scalar ``-max + ptp/2`` over
    the raw array, and the remaining steps
    (:func:`solve_from_boundary_stream`) are linear in the boundary values.
    A terminal-current sweep uses exactly this decomposition.

    With ``hp_system`` (a :class:`.refine.HighPrecisionSystem`), every
    product and solve is float64: the float64 blocks with the float32
    factors (see :func:`solve_from_boundary_stream`).
    """
    npoints = len(device.meshes[film_info.name].sites)
    if not any(terminal_currents.values()):
        return np.zeros(npoints)
    g = terminal_boundary_stream(device, film_info, terminal_systems, terminal_currents)
    # The interior entries are still zero here, so max/ptp see them too.
    g = g - np.max(g) + np.ptp(g) / 2
    return solve_from_boundary_stream(device, film_info, terminal_systems, g, hp_system=hp_system)


def terminal_boundary_stream(
    device: Device,
    film_info: FilmInfo,
    terminal_systems: TerminalSystems,
    terminal_currents: Dict[str, float],
) -> np.ndarray:
    """Raw (uncentered) boundary stream of a transport drive: ``(n,)`` with
    the boundary entries set and interior zeros.  Linear in the terminal
    currents."""
    return boundary_stream_from_indices(
        device,
        film_info.name,
        np.asarray(terminal_systems.boundary.indices),
        terminal_currents,
    )


def boundary_stream_from_indices(
    device: Device,
    film_name: str,
    boundary_indices: np.ndarray,
    terminal_currents: Dict[str, float],
) -> np.ndarray:
    """The terminal boundary walk given explicit CCW boundary indices: each
    terminal's stream ramps across its own boundary vertices and stays at
    its end value along the rest of the cycle."""
    points = device.meshes[film_name].sites
    boundary_points = points[boundary_indices]
    g = np.zeros(len(points))
    for terminal in device.terminals[film_name]:
        current = terminal_currents.get(terminal.name, 0.0)
        ix_boundary = np.sort(terminal.contains_points(boundary_points, index=True))
        remaining_boundary = boundary_indices[ix_boundary[-1] :]
        ix_terminal = boundary_indices[ix_boundary]
        stream = stream_from_terminal_current(points[ix_terminal], -current)
        g[ix_terminal[:-1]] += stream
        g[remaining_boundary] += stream[-1]
    return g


def solve_from_boundary_stream(
    device: Device,
    film_info: FilmInfo,
    terminal_systems: TerminalSystems,
    g: np.ndarray,
    hp_system=None,
) -> np.ndarray:
    """Bootstrap steps 2-3 given the (already centered) boundary stream:
    solve the film interior ignoring holes, then pin each hole to its
    weighted average and re-solve.  Linear in ``g``'s boundary values.  The
    matrix products and solves run on the systems' torch device; ``g``
    stays a float64 host array.  With ``hp_system`` they run on its
    float64 blocks, and each solve is refined to float64 around the
    float32 factors.  While a profiler runs, the copies count in
    :mod:`~superscreen_tpu_torch.tracing`'s transfer counters and each
    solve in its ``terminal_solves``."""
    if hp_system is not None:
        terminal_systems = _hp_terminal_systems(terminal_systems, hp_system)
    weights = device.meshes[film_info.name].operators.weights
    g = np.array(g, dtype=float, copy=True)

    def effective_field(system: LinearSystem) -> np.ndarray:
        # ``-A @ g`` over the rectangular column block (all rows, the
        # boundary's or a hole's columns), summed in float64 whatever the
        # block's dtype.
        A = system.A
        x = tracing.to_device(g[system.indices, None], A.device)
        zero = torch.zeros((A.shape[0], 1), dtype=torch.float64, device=A.device)
        return -tracing.to_host(linalg.system_residual(A, zero, x)[:, 0]).numpy()

    def solve(system: LinearSystem, Ha_eff: np.ndarray) -> None:
        h = tracing.to_device(-Ha_eff[system.indices], system.A.device, system.A.dtype)
        tracing.count(tracing.TERMINAL_SOLVES)
        g[system.indices] = tracing.to_host(
            linalg.lu_solve_refined(system.A, system.lu_piv, h)
        ).numpy()

    solve(terminal_systems.film_without_boundary, effective_field(terminal_systems.boundary))
    if not terminal_systems.holes:
        return g
    Ha_eff = np.zeros(len(g))
    for system in terminal_systems.holes.values():
        ix = system.indices
        g[ix] = np.average(g[ix], weights=weights[ix])
        Ha_eff += effective_field(system)
    Ha_eff += effective_field(terminal_systems.boundary)
    solve(terminal_systems.film_without_boundary_or_holes, Ha_eff)
    return g


def _hp_terminal_systems(terminal_systems: TerminalSystems, hp_system) -> TerminalSystems:
    """The float64 terminal systems of ``hp_system`` with the float32
    factors of ``terminal_systems``: the bootstrap's solves are then
    refined to float64 (:func:`ops.linalg.lu_solve_refined`)."""
    ts = terminal_systems
    rest = ts.film_without_boundary_or_holes
    return TerminalSystems(
        film=ts.film,
        boundary=LinearSystem(A=hp_system.boundary_eff64, indices=ts.boundary.indices),
        holes={
            name: LinearSystem(A=hp_system.hole_eff64[name], indices=system.indices)
            for name, system in ts.holes.items()
        },
        film_without_boundary=LinearSystem(
            A=hp_system.fwb_A64,
            indices=ts.film_without_boundary.indices,
            lu_piv=ts.film_without_boundary.lu_piv,
        ),
        film_without_boundary_or_holes=None if rest is None else LinearSystem(
            A=hp_system.fwboh_A64, indices=rest.indices, lu_piv=rest.lu_piv
        ),
    )


def solve_film(
    *,
    device: Device,
    applied_field,
    film_info: FilmInfo,
    film_system: LinearSystem,
    hole_systems: Dict[str, LinearSystem],
    field_conversion: float,
    vortex_flux: float,
    terminal_systems: Optional[TerminalSystems] = None,
    field_from_other_films=None,
    check_inversion: bool = False,
    hp_system=None,
) -> FilmSolution:
    """Computes the stream function and fields within a single film, for
    one drive, on the torch device that holds its systems.

    Counterpart of ``superscreen_tpu.solver.solve_film.solve_film``: the
    hole boundary conditions (dense effective-field blocks, or the
    low-memory row-sum vectors), the transport stream of a film with
    terminals and its boundary effective field, the interior solve (LU
    with two float64-residual refinement steps, or the film's CG or
    BiCGStab route), the vortex response columns (Brandt Eq. 28, one
    refined solve over their unit columns), the current density by the
    gather-form vertex gradients and the self-field: ``Q (w g)`` with the
    film's dense kernel, matrix-free through ``q_apply`` on the low-memory
    path (or once a model's sweep data has taken the kernel), and the
    in-film Biot-Savart sum over triangle centroids for a film with
    terminals.

    Args:
        device: The device being solved.
        applied_field: Applied field at the film's mesh sites in solver
            units (``current_units / length_units``), NumPy or a tensor.
        film_info: The film's :class:`FilmInfo`.
        film_system: The film's :class:`LinearSystem`.
        hole_systems: ``{hole_name: LinearSystem}``.
        field_conversion: Factor from the user's field units to solver
            units.
        vortex_flux: Flux of one vortex in solver units.
        terminal_systems: The film's :class:`TerminalSystems`, if it has
            terminals.
        field_from_other_films: Screening field from the other films in
            solver units, NumPy or a tensor.
        check_inversion: Warn, as :func:`superscreen_tpu_torch.solve`
            does, if ``-A g`` does not reproduce the right-hand side within
            ``numpy.allclose``'s tolerances.
        hp_system: A :class:`superscreen_tpu_torch.solver.refine.HighPrecisionSystem`
            of the film: every solve is refined to float64 around the
            film's factors (:func:`ops.linalg.refined_solve`), and the hole
            fields, the current density and the self-field are float64.

    Returns:
        A :class:`FilmSolution`, fields in the user's units.
    """
    from ..sweep import _check_inversion, _terminal_boundary_ha

    name = film_info.name
    mesh = device.meshes[name]
    points = mesh.sites
    weights = film_info.weights if hp_system is None else hp_system.weights64
    dtype, torch_device = weights.dtype, weights.device

    def tensor(array) -> torch.Tensor:
        return torch.as_tensor(array).to(dtype=dtype, device=torch_device)

    applied_field = tensor(applied_field)
    Hz = applied_field
    if field_from_other_films is not None:
        field_from_other_films = tensor(field_from_other_films)
        Hz = Hz + field_from_other_films
    g = torch.zeros_like(Hz)
    Ha_eff = torch.zeros_like(Hz)

    # Hole boundary conditions: g[hole] = I_circ and its effective field.
    for hole, system in hole_systems.items():
        idx = torch.as_tensor(system.indices, device=torch_device)
        current = film_info.circulating_currents.get(hole, 0)
        g[idx] += current
        A = system.A if hp_system is None else hp_system.hole_eff64[hole]
        if A.ndim == 1:
            # Low-memory: the effective field of a unit circulating current.
            Ha_eff -= A * current
        else:
            Ha_eff -= A @ g[idx]

    if name in device.terminals:
        g_transport = solve_for_terminal_current_stream(
            device, film_info, terminal_systems, film_info.terminal_currents or {},
            hp_system=hp_system,
        )
        g += tensor(g_transport)
        Ha_eff += tensor(
            _terminal_boundary_ha(points, film_info.boundary_indices, g_transport, weights)
        )

    idx = torch.as_tensor(film_system.indices, device=torch_device)
    h = (Hz - Ha_eff)[idx]
    matrix_free = hp_system is None and film_system.cg_op is not None
    if hp_system is not None:
        A = hp_system.A64
        precond = linalg.mixed_preconditioner(film_system.lu_piv, dtype)

        def solve(rhs):
            return linalg.refined_solve(A, precond, rhs)

    elif matrix_free:
        A = None

        def solve(rhs):
            cols = rhs[:, None] if rhs.ndim == 1 else rhs
            x = linalg.matrix_free_solve_host(film_system.cg_op, cols)
            return x[:, 0] if rhs.ndim == 1 else x

    else:
        A = film_system.A

        def solve(rhs):
            return linalg.lu_solve_refined(A, film_system.lu_piv, rhs)

    gf = solve(h)
    g[idx] += gf
    if check_inversion and A is not None:
        _check_inversion(name, A, h[:, None], gf[:, None])

    if film_info.vortices:
        # Brandt Eq. 28: one solve over the vortices' unit columns.
        rhs = torch.zeros((len(idx), len(film_info.vortices)), dtype=dtype, device=torch_device)
        scales = torch.zeros(len(film_info.vortices), dtype=dtype, device=torch_device)
        film_points = points[film_system.indices]
        for k, vortex in enumerate(film_info.vortices):
            xy = (vortex.x, vortex.y)
            j_film = int(np.argmin(np.linalg.norm(film_points - xy, axis=1)))
            j_device = int(np.argmin(np.linalg.norm(points - xy, axis=1)))
            rhs[j_film, k] = 1.0
            scales[k] = vortex_flux * vortex.nPhi0 / weights[j_device]
        g[idx] += -solve(rhs) @ scales

    # Current density J = curl(g z) = (dg/dy, -dg/dx).
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    ops = mesh.operators

    def grad(op, x):
        return gather_matvec(*op.to_gather(np_dtype, torch_device), x)

    J = torch.stack([grad(ops.gradient_y, g), -grad(ops.gradient_x, g)], dim=1)
    sites = tensor(points if hp_system is not None else film_info.sites)
    if name in device.terminals:
        J_tri = torch.stack([grad(ops.gradient_tri_y, g), -grad(ops.gradient_tri_x, g)], dim=1)
        screening_field = kernels.biot_savart_within_film(
            sites, tensor(mesh.triangle_centroids), tensor(mesh.triangle_areas), J_tri
        )
    elif hp_system is not None:
        # Q (w g) with Q_ii w_i = brandt_diag_i and -q_ij off the diagonal.
        screening_field = hp_system.brandt_diag64 * g - kernels.q_apply(
            sites, (weights * g)[:, None]
        )[:, 0]
    elif film_info.kernel is not None:
        # Q (w g), summed in float64 for a float32 kernel (as the sweep
        # sums its self-field: the terms cancel to a small part of their sum).
        wg = (weights * g)[:, None]
        if film_info.kernel.dtype == torch.float32:
            screening_field = kernels.residual_f64(film_info.kernel, wg, out_dtype=dtype)[:, 0]
        else:
            screening_field = (film_info.kernel @ wg)[:, 0].to(dtype)
    else:
        screening_field = kernels.Q_apply(sites, weights, weights * g)

    def user_units(t):
        return None if t is None else (t / field_conversion).cpu().numpy()

    return FilmSolution(
        stream=g.cpu().numpy(),
        current_density=J.cpu().numpy(),
        applied_field=user_units(applied_field),
        self_field=user_units(screening_field),
        field_from_other_films=user_units(field_from_other_films),
    )

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
ceiling, it is not materialized at all and is solved on the matrix-free
operator: by CG, or by BiCGStab when its Lambda is inhomogeneous.  Its
hole systems are the row-sum vectors themselves.

An inhomogeneous Lambda adds the ``(grad Lambda) . grad`` term to every
system: a dense block on the dense path, COO triplets folded into the
Laplacian's on the low-memory path.

A film with transport terminals gets :class:`TerminalSystems`, whose
interior block doubles as the film's main system, and its transport
stream from :func:`solve_for_terminal_current_stream`.
"""

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import Device
from ..io import new_group
from ..ops import kernels, linalg
from ..ops.fem import COO
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
    "permutation_to_pivots",
    "pivots_to_permutation",
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
        A: The matrix ``Q diag(w) - Lambda laplacian - (grad Lambda) .
            grad`` restricted to ``indices`` (rows and columns for a film,
            columns for a hole or a boundary).
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

    def to_hdf5(self, h5group) -> None:
        """Writes the system into ``h5group`` (an ``h5py.Group``) in the JAX
        package's layout: ``A``, ``indices``, and the factors as ``lu`` and
        0-based LAPACK ``piv`` (the JAX package's convention); the
        matrix-free pieces of a film solved by CG or BiCGStab go to a
        ``matrix_free`` group of this package's own.  The tensors come to
        the host here."""
        if self.A is not None:
            h5group["A"] = self.A.cpu().numpy()
        h5group["indices"] = np.asarray(self.indices)
        if self.lu_piv is not None:
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

        A JAX low-memory film's LU system is padded with a decoupled
        identity block up to a multiple of 2048: ``A``, ``lu`` and ``piv``
        are cut back to ``len(indices)`` (partial pivoting never leaves the
        film's block, so the cut factors are those of the film's system).
        A system the JAX package factorized in a way this package does not
        (its ``"cg"``, ``"chol"`` and ``"inv"`` factorizations) raises
        ``NotImplementedError`` naming the tag.
        """
        for tag, key in (("cg", "cg_sub_sites"), ("chol", "chol_L"), ("inv", "inv_M")):
            if key in h5group:
                raise NotImplementedError(
                    f"The system's {tag!r} factorization of the JAX package has no "
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
    device: Device, film_info_dict: Dict[str, FilmInfo], assemble_only: bool = False
) -> Tuple[
    Dict[str, LinearSystem],
    Dict[str, Dict[str, LinearSystem]],
    Dict[str, TerminalSystems],
]:
    """Builds and factorizes the linear systems for all films, holes and
    terminals.

    Each dense film's Laplacian (and gradient pair) is released once its
    systems are built.  A low-memory film is LU-factorized from its
    materialized interior system, or, with
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

    def factor(A):
        return None if assemble_only else linalg.factor_system(A)

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
            if not assemble_only and (
                method == "cg" or len(interior) > max_materialized_n(info.weights.dtype)
            ):
                film_systems[film_name] = LinearSystem(
                    A=None,
                    indices=interior,
                    cg_op=_lowmem_operator_pieces(info, interior, sites),
                )
            else:
                A = _build_system_2d_lowmem(info, interior, sites)
                film_systems[film_name] = LinearSystem(A=A, indices=interior, lu_piv=factor(A))
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
            return LinearSystem(A=A, indices=indices, lu_piv=factor(A))

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
    """
    npoints = len(device.meshes[film_info.name].sites)
    if not any(terminal_currents.values()):
        return np.zeros(npoints)
    g = terminal_boundary_stream(device, film_info, terminal_systems, terminal_currents)
    # The interior entries are still zero here, so max/ptp see them too.
    g = g - np.max(g) + np.ptp(g) / 2
    return solve_from_boundary_stream(device, film_info, terminal_systems, g)


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
) -> np.ndarray:
    """Bootstrap steps 2-3 given the (already centered) boundary stream:
    solve the film interior ignoring holes, then pin each hole to its
    weighted average and re-solve.  Linear in ``g``'s boundary values.  The
    matrix products and solves run on the systems' torch device; ``g``
    stays a float64 host array."""
    weights = device.meshes[film_info.name].operators.weights
    g = np.array(g, dtype=float, copy=True)

    def effective_field(system: LinearSystem) -> np.ndarray:
        # ``-A @ g`` over the rectangular column block (all rows, the
        # boundary's or a hole's columns), summed in float64 whatever the
        # block's dtype.
        A = system.A
        x = torch.as_tensor(g[system.indices, None], device=A.device)
        zero = torch.zeros((A.shape[0], 1), dtype=torch.float64, device=A.device)
        return -linalg.system_residual(A, zero, x)[:, 0].cpu().numpy()

    def solve(system: LinearSystem, Ha_eff: np.ndarray) -> None:
        h = torch.as_tensor(
            -Ha_eff[system.indices], dtype=system.A.dtype, device=system.A.device
        )
        g[system.indices] = linalg.lu_solve_refined(system.A, system.lu_piv, h).cpu().numpy()

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

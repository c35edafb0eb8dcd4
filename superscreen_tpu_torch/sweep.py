"""The batched solve machinery behind :func:`solve`.

Counterpart of the LU, CG and exact-coupling parts of
``superscreen_tpu/sweep.py``.  ``B`` right-hand sides (sweep points) are
solved at once against each film's LU factorization, or by matrix-free CG
for a film whose system is not materialized; the self-consistent
inter-film coupling runs as a Python loop of rounds, each an exact
pairwise Biot-Savart exchange through the ``biot_savart_batch`` kernel
(or ``biot_savart_pair`` with ``SUPERSCREEN_TPU_PAIR_COUPLING=1``).  The
self-field of a low-memory film is applied matrix-free through
``q_apply``.  All tensors stay on the model's torch device.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import kernels
from .ops import linalg

__all__ = ["FilmSweepData", "relative_residual"]


@dataclass
class FilmSweepData:
    """Sweep-independent tensors for one film.

    Args:
        name: Film name.
        n: Number of mesh sites.
        interior: ``(ni,)`` mesh indices of the film's system.
        lu, perm: LU factorization of ``-A`` (packed factors and row
            permutation, see :func:`ops.linalg.factor_system`); None for
            a CG film.
        A: ``(ni, ni)`` film system (for the refinement residual); None
            for a CG film.
        Qw: ``(n, n)`` Brandt kernel with the vertex areas folded into its
            columns, ``Q diag(w)``: the self-field is ``Qw @ g``.  None on
            the low-memory path, where the self-field is applied
            matrix-free.
        weights: ``(n,)`` vertex areas.
        gx_idx, gx_w, gy_idx, gy_w: Vertex gradients in gather form.
        sites: ``(n, 2)`` mesh sites.
        z0: Layer height.
        hole_masks: ``(n_holes, n)`` 1.0 where a site is in the hole.
        hole_ha_vecs: ``(n_holes, n)`` effective field of a unit
            circulating current in each hole.
        hole_names: Hole names, in the order of the rows above.
        cg_op: Matrix-free operator pieces of a CG film, else None.
        fac_kind: ``"lu"`` or ``"cg"``: how the film's system is solved.
    """

    name: str
    n: int
    interior: torch.Tensor
    lu: Optional[torch.Tensor]
    perm: Optional[torch.Tensor]
    A: Optional[torch.Tensor]
    Qw: Optional[torch.Tensor]
    weights: torch.Tensor
    gx_idx: torch.Tensor
    gx_w: torch.Tensor
    gy_idx: torch.Tensor
    gy_w: torch.Tensor
    sites: torch.Tensor
    z0: float
    hole_masks: torch.Tensor
    hole_ha_vecs: torch.Tensor
    hole_names: Sequence[str] = field(default_factory=list)
    cg_op: Optional[Dict[str, torch.Tensor]] = None
    fac_kind: str = "lu"


def _coo_to_gather(coo, n_rows: int, dtype, torch_device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Converts COO triplets to fixed-fan-in gather form: ``(n_rows, d)``
    column indices and weights, zero-weight padded."""
    rows = np.asarray(coo.rows)
    order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    cols_s = np.asarray(coo.cols)[order]
    vals_s = np.asarray(coo.vals)[order]
    counts = np.bincount(rows_s, minlength=n_rows)
    d = int(counts.max()) if len(counts) else 1
    idx = np.zeros((n_rows, d), dtype=np.int64)
    w = np.zeros((n_rows, d), dtype=dtype)
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(rows_s)) - np.repeat(starts, counts)
    idx[rows_s, pos] = cols_s
    w[rows_s, pos] = vals_s
    return (
        torch.as_tensor(idx, device=torch_device),
        torch.as_tensor(w, device=torch_device),
    )


def _gather_matvec_batch(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Batched sparse matvec in gather form: ``(n_out, d)`` indices and
    weights applied to ``g`` of shape ``(B, n)``."""
    return torch.sum(w[None, :, :] * g[:, idx], dim=-1)


def film_sweep_data(model, film_name: str) -> FilmSweepData:
    """Builds a film's :class:`FilmSweepData` from a factorized model.

    For a dense film, ``Q diag(w)`` is formed in place in the film's ``Q``
    buffer, which the film info then releases: the solve needs nothing
    else of ``Q``.  A low-memory film keeps no kernel (``Qw`` is None).
    """
    device = model.device
    info = model.film_info[film_name]
    system = model.film_systems[film_name]
    mesh = device.meshes[film_name]
    torch_device = model.torch_device
    n = len(mesh.sites)
    dtype = device.solve_dtype
    w = info.weights
    hole_names = list(info.hole_indices)
    hole_masks = torch.zeros((len(hole_names), n), dtype=w.dtype, device=torch_device)
    hole_ha = torch.zeros_like(hole_masks)
    for k, hole in enumerate(hole_names):
        idx = torch.as_tensor(info.hole_indices[hole], device=torch_device)
        hole_masks[k, idx] = 1.0
        # Effective field from a unit circulating current in this hole:
        # -(A_hole @ 1), already a vector on the low-memory path.
        A_hole = model.hole_systems[film_name][hole].A
        if A_hole.ndim == 1:
            hole_ha[k] = -A_hole
        else:
            hole_ha[k] = -(A_hole @ torch.ones(len(idx), dtype=w.dtype, device=torch_device))
    gx_idx, gx_w = _coo_to_gather(mesh.operators.gradient_x, n, dtype, torch_device)
    gy_idx, gy_w = _coo_to_gather(mesh.operators.gradient_y, n, dtype, torch_device)
    Qw = None
    if info.dense_kernel:
        Qw = info.kernel.mul_(w[None, :])
        info.kernel = None
    lu, perm = system.lu_piv if system.cg_op is None else (None, None)
    return FilmSweepData(
        name=film_name,
        n=n,
        interior=torch.as_tensor(system.indices, device=torch_device),
        lu=lu,
        perm=perm,
        A=system.A,
        Qw=Qw,
        weights=w,
        gx_idx=gx_idx,
        gx_w=gx_w,
        gy_idx=gy_idx,
        gy_w=gy_w,
        sites=torch.as_tensor(info.sites, device=torch_device),
        z0=float(device.layers[info.layer].z0),
        hole_masks=hole_masks,
        hole_ha_vecs=hole_ha,
        hole_names=hole_names,
        cg_op=system.cg_op,
        fac_kind="lu" if system.cg_op is None else "cg",
    )


def _self_field_batch(data: FilmSweepData, g: torch.Tensor) -> torch.Tensor:
    """Self-field ``Q @ (w * g)`` for ``g`` of shape ``(B, n)``: one
    product with ``Q diag(w)``, or on the low-memory path one matrix-free
    :func:`ops.kernels.Q_apply` over all ``B`` columns."""
    if data.Qw is None:
        return kernels.Q_apply(data.sites, data.weights, (data.weights[None, :] * g).T).T
    return (data.Qw @ g.T).T


def _interior_rhs(data: FilmSweepData, Hz_total, I_circ):
    """Hole stream offsets ``g0`` ``(B, n)`` and the interior right-hand
    side ``h`` ``(B, ni)`` of ``(-A) g = h``."""
    if data.hole_masks.shape[0]:
        g0 = I_circ @ data.hole_masks
        Ha_eff = I_circ @ data.hole_ha_vecs
    else:
        g0 = torch.zeros_like(Hz_total)
        Ha_eff = torch.zeros_like(Hz_total)
    return g0, (Hz_total - Ha_eff)[:, data.interior]


def _solve_film_batch(
    data: FilmSweepData,
    Hz_total: torch.Tensor,  # (B, n): applied + field from other films
    I_circ: torch.Tensor,  # (B, n_holes)
    refine_steps: int = 2,
):
    """Batched single-film solve.  Returns ``g`` ``(B, n)`` and ``J``
    ``(B, n, 2)``."""
    g0, h = _interior_rhs(data, Hz_total, I_circ)
    hT = h.T.contiguous()  # (ni, B)
    if data.fac_kind == "cg":
        # CG controls its own accuracy: no refinement (and no A for it).
        gf = linalg.brandt_cg_solve_host(data.cg_op, hT)
    else:

        def solve(rhs):
            return linalg.lu_solve((data.lu, data.perm), rhs)

        gf = solve(hT)
        if refine_steps:
            gf = linalg.refine_safeguarded(solve, data.A, hT, gf, refine_steps)
    # The interior indices are unique, so the scatter-add is exact.
    g = g0.index_add(1, data.interior, gf.T)
    Jx = _gather_matvec_batch(data.gy_idx, data.gy_w, g)
    Jy = -_gather_matvec_batch(data.gx_idx, data.gx_w, g)
    return g, torch.stack([Jx, Jy], dim=-1)


def _coupling_round(film_data: Dict[str, FilmSweepData], films: List[str], Js, Hz_applied):
    """One exact inter-film coupling exchange over unordered film pairs:
    two one-way ``biot_savart_batch`` passes per pair, or one
    ``biot_savart_pair`` pass with ``SUPERSCREEN_TPU_PAIR_COUPLING=1``.
    Returns the field each film feels from all others, ``{film: (B, n)}``."""
    new_others = {name: torch.zeros_like(Hz_applied[name]) for name in films}
    for ai, a in enumerate(films):
        for b in films[ai + 1 :]:
            da, db = film_data[a], film_data[b]
            at_b, at_a = kernels.biot_savart_pair_dz2(
                da.sites, da.weights, Js[a], db.sites, db.weights, Js[b],
                (db.z0 - da.z0) ** 2,
            )
            new_others[b] += at_b
            new_others[a] += at_a
    return new_others


def _run_sweep_history(film_data, Hz_applied, I_circ, iterations: int, refine_steps: int):
    """The initial per-film solves plus ``iterations`` coupling rounds,
    recording every round.

    Returns per-film dicts of stacked tensors with a leading history axis
    of length ``iterations + 1``: ``gs (I+1, B, n)``, ``Js (I+1, B, n, 2)``,
    ``self_fields (I+1, B, n)`` and ``others (I+1, B, n)`` (``others[0]``
    is zero: the initial solve sees only the applied field).
    """
    films = list(film_data)
    gs = {name: [] for name in films}
    Js = {name: [] for name in films}
    others = {name: [torch.zeros_like(Hz_applied[name])] for name in films}
    for name in films:
        g, J = _solve_film_batch(film_data[name], Hz_applied[name], I_circ[name], refine_steps)
        gs[name].append(g)
        Js[name].append(J)
    for _ in range(iterations):
        new_others = _coupling_round(
            film_data, films, {name: Js[name][-1] for name in films}, Hz_applied
        )
        for name in films:
            g, J = _solve_film_batch(
                film_data[name],
                Hz_applied[name] + new_others[name],
                I_circ[name],
                refine_steps,
            )
            gs[name].append(g)
            Js[name].append(J)
            others[name].append(new_others[name])
    gs = {name: torch.stack(v) for name, v in gs.items()}
    Js = {name: torch.stack(v) for name, v in Js.items()}
    others = {name: torch.stack(v) for name, v in others.items()}
    # One batched self-field product per film over the whole history.
    self_fields = {}
    for name in films:
        H, B, n = gs[name].shape
        flat = gs[name].reshape(H * B, n)
        self_fields[name] = _self_field_batch(film_data[name], flat).reshape(H, B, n)
    return gs, Js, self_fields, others


def relative_residual(data: FilmSweepData, Hz_total, I_circ, g) -> torch.Tensor:
    """Relative residual ``||h + A g_int|| / ||h||`` of a film's interior
    system for a solved stream ``g`` ``(B, n)``, one value per batch row.
    A CG film has no ``A``: its product is applied matrix-free."""
    _, h = _interior_rhs(data, Hz_total, I_circ)
    g_int = g[:, data.interior].T
    if data.A is None:
        r = h.T + linalg.brandt_matvec(data.cg_op, g_int)
    else:
        r = h.T + data.A @ g_int
    return torch.linalg.vector_norm(r, dim=0) / torch.linalg.vector_norm(h.T, dim=0)

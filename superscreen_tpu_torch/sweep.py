"""Batched parameter sweeps: :func:`solve_many` and the machinery behind
it and behind :func:`solve`.

Counterpart of ``superscreen_tpu/sweep.py``.  A sweep over ``B``
parameter sets (applied fields, circulating currents, terminal currents,
vortex amplitudes) reuses one factorization: the ``B`` right-hand sides
are solved at once against each film's factors (one product with the
explicit inverse of a large film on the card, triangular solves with LU
or Cholesky factors), or matrix-free (CG, or
BiCGStab for an inhomogeneous Lambda) for a film whose system is not
materialized; hole, vortex and transport contributions are batched
rank-one terms; and the self-consistent inter-film coupling runs as a
Python loop of rounds.  A round is either an exact pairwise Biot-Savart
exchange through the ``biot_savart_batch`` kernel (or ``biot_savart_pair``
with ``SUPERSCREEN_TPU_PAIR_COUPLING=1``), or the FFT transfer of
:mod:`.ops.fft_coupling`; ``coupling="auto"`` picks one by a per-round
cost model fitted on the card (:func:`_resolve_auto_coupling`).  The
self-field of a low-memory film is applied matrix-free through
``q_apply``, that of a film with terminals through the in-film
Biot-Savart sum.

:func:`solve_many` and :func:`superscreen_tpu_torch.solve` share one
path from their inputs on the torch device to the host arrays: the
device half :func:`_sweep_on_device` (the film data brought up to date,
the one round loop :func:`_run_sweep`, with or without its history, and
the float64 polish) and the results half :meth:`_DeviceSweep.to_host`,
which brings each quantity back to the host once, inside one
``sweep.to_host`` span.  Each entry point keeps only its own argument
checks, its ``sweep.inputs`` block and its packaging (a
:class:`SweepResult`, or one :class:`Solution` per round).
"""

import logging
import os
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import tracing
from .geometry import close_curve, path_vectors
from .ops import kernels
from .ops import linalg
from .ops.fem import gather_matvec_batch
from .ops.rows import RowSharded, row_bounds
from .parallel.sharding import DataSharded, ShardedFilmData
from .solution import FilmSolution, Solution, Vortex
from .sources import ConstantField

logger = logging.getLogger("solve")

__all__ = ["FilmSweepData", "SweepResult", "relative_residual", "solve_many"]


@dataclass
class FilmSweepData:
    """Sweep-independent tensors for one film.

    Args:
        name: Film name.
        n: Number of mesh sites.
        interior: ``(ni,)`` mesh indices of the film's system.
        factors: The film's factors of ``-A`` as
            :func:`ops.linalg.lu_solve` takes them (the system's
            ``lu_piv``): ``(lu, perm)``, the packed LU and row
            permutation, ``("inv", M, w)`` for an ``"inv"`` film, the
            explicit solution operator (row-sharded, an
            :class:`ops.rows.RowSharded`, for a film inverted over a mesh)
            and the column weights, or ``("chol", L, w)`` for a
            ``"chol"`` film; None for a matrix-free film.
        A: ``(ni, ni)`` film system (for the refinement residual); None
            for a matrix-free film; row-sharded for a film inverted over a
            mesh.
        Qw: ``(n, n)`` Brandt kernel with the vertex areas folded into its
            columns, ``Q diag(w)``: the self-field is ``Qw @ g``.  None on
            the low-memory path, where the self-field is applied
            matrix-free, and for a film with terminals.
        weights: ``(n,)`` vertex areas.
        gx_idx, gx_w, gy_idx, gy_w: Vertex gradients in gather form.
        sites: ``(n, 2)`` mesh sites.
        z0: Layer height.
        hole_masks: ``(n_holes, n)`` 1.0 where a site is in the hole.
        hole_ha_vecs: ``(n_holes, n)`` effective field of a unit
            circulating current in each hole.
        hole_names: Hole names, in the order of the rows above.
        cg_op: Matrix-free operator pieces of a CG or BiCGStab film, else
            None.
        fac_kind: ``"lu"``, ``"inv"``, ``"chol"`` (see
            :func:`ops.linalg.factor_system`), ``"cg"`` or
            ``"bicgstab"``: how the film's system is solved.
        vortex_cols: ``(ni, n_vortices)`` response of the interior stream
            to a unit source at each vortex site, or None.
        vortex_scales: ``(n_vortices,)`` ``1 / w_j`` at each vortex site.
        vortex_nphi0: Declared amplitudes ``(n_vortices,)``, or
            ``(B, n_vortices)`` for a per-point amplitude sweep.
        terminal: True for a film with transport terminals.
        g_offset, ha_offset: The transport stream and its boundary
            effective field: ``(n,)`` fixed across the sweep, or ``(B, n)``
            for a per-point terminal-current sweep.
        tri_centroids, tri_areas: ``(m, 2)`` and ``(m,)`` triangle data of
            a terminal film, for its in-film Biot-Savart self-field.
        gtx_idx, gtx_w, gty_idx, gty_w: Its triangle gradients in gather
            form.
        fft_grid: The film's :class:`ops.fft_coupling.FilmGridData` when
            the sweep couples through the FFT transfer, else None.
        brandt_diag: ``(n,)`` ``C + q @ w`` at all sites (the Brandt
            kernel's diagonal times ``w``), set for the float64 film data
            of a high-precision model, whose self-field is
            ``brandt_diag * g - q_apply(w g)``; else None.

    In the float64 film data of a high-precision model (see
    :mod:`superscreen_tpu_torch.solver.refine`) ``A`` is float64 while
    ``factors`` stay the float32 factorization: the film solve is then
    :func:`ops.linalg.refined_solve` with the factors as preconditioner.
    """

    name: str
    n: int
    interior: torch.Tensor
    factors: Optional[tuple]
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
    vortex_cols: Optional[torch.Tensor] = None
    vortex_scales: Optional[torch.Tensor] = None
    vortex_nphi0: Optional[torch.Tensor] = None
    terminal: bool = False
    g_offset: Optional[torch.Tensor] = None
    ha_offset: Optional[torch.Tensor] = None
    tri_centroids: Optional[torch.Tensor] = None
    tri_areas: Optional[torch.Tensor] = None
    gtx_idx: Optional[torch.Tensor] = None
    gtx_w: Optional[torch.Tensor] = None
    gty_idx: Optional[torch.Tensor] = None
    gty_w: Optional[torch.Tensor] = None
    brandt_diag: Optional[torch.Tensor] = None
    fft_grid: Optional[object] = None


def vortex_flux_quantum(device, current_units: str) -> float:
    """``Phi_0 / mu_0`` in ``current_units * length_units``: the strength
    of a one-quantum vortex source."""
    return (
        device.ureg("Phi_0 / mu_0").to(f"{current_units} * {device.length_units}").magnitude
    )


def vortex_snapshot(model) -> tuple:
    """The model's vortex configuration, the only mutable state baked into
    :class:`FilmSweepData` (circulating currents enter as runtime inputs)."""
    return tuple((name, tuple(info.vortices or ())) for name, info in model.film_info.items())


def _vortex_response(model, film_name: str) -> Dict[str, Optional[torch.Tensor]]:
    """The vortex fields of a film's :class:`FilmSweepData`: one response
    column per vortex (fixed positions; amplitudes may vary per sweep
    point), solved in the solve dtype through the film's own factorization
    or matrix-free operator."""
    info = model.film_info[film_name]
    if not info.vortices:
        return dict(vortex_cols=None, vortex_scales=None, vortex_nphi0=None)
    system = model.film_systems[film_name]
    points = model.device.meshes[film_name].sites
    w = info.weights
    rhs = torch.zeros((len(system.indices), len(info.vortices)), dtype=w.dtype, device=w.device)
    scales = torch.zeros(len(info.vortices), dtype=w.dtype, device=w.device)
    for k, vortex in enumerate(info.vortices):
        xy = (vortex.x, vortex.y)
        j_film = int(np.argmin(np.linalg.norm(points[system.indices] - xy, axis=1)))
        j_device = int(np.argmin(np.linalg.norm(points - xy, axis=1)))
        rhs[j_film, k] = 1.0
        scales[k] = 1.0 / w[j_device]
    if system.cg_op is None:
        cols = -linalg.lu_solve_refined(system.A, system.lu_piv, rhs)
    else:
        cols = -linalg.matrix_free_solve_host(system.cg_op, rhs)
    return dict(
        vortex_cols=cols,
        vortex_scales=scales,
        vortex_nphi0=torch.tensor(
            [vortex.nPhi0 for vortex in info.vortices], dtype=w.dtype, device=w.device
        ),
    )


def _terminal_boundary_ha(
    points: np.ndarray, boundary_indices: np.ndarray, g_tr: np.ndarray, like: torch.Tensor
) -> np.ndarray:
    """Effective applied field ``(n,)`` of a transport stream ``g_tr``'s
    boundary values, computed on the device and in the dtype of ``like``."""
    boundary_sites = points[boundary_indices]
    boundary_stream = g_tr[boundary_indices]
    centers = 0.5 * (boundary_sites + np.roll(boundary_sites, -1, axis=0))
    stream_mid = 0.5 * (boundary_stream + np.roll(boundary_stream, -1, axis=0))
    edge_lengths, normals = path_vectors(close_curve(boundary_sites))
    ha = kernels.boundary_effective_field(
        *(
            tracing.to_device(a, like.device, like.dtype)
            for a in (points, centers, edge_lengths, normals, stream_mid)
        )
    )
    return tracing.to_host(ha).numpy()


def _terminal_fields(model, film_name: str) -> Dict[str, object]:
    """The transport fields of a terminal film's :class:`FilmSweepData`:
    the stream of the model's terminal currents and its boundary effective
    field (fixed offsets of every solve), and the triangle data of the
    in-film Biot-Savart self-field."""
    from .solver.solve_film import solve_for_terminal_current_stream

    info = model.film_info[film_name]
    mesh = model.device.meshes[film_name]
    w = info.weights
    dtype = info.sites.dtype
    g_tr = solve_for_terminal_current_stream(
        model.device, info, model.terminal_systems[film_name], info.terminal_currents or {}
    )
    ha = _terminal_boundary_ha(mesh.sites, info.boundary_indices, g_tr, w)
    gtx_idx, gtx_w = mesh.operators.gradient_tri_x.to_gather(dtype, w.device)
    gty_idx, gty_w = mesh.operators.gradient_tri_y.to_gather(dtype, w.device)
    return dict(
        terminal=True,
        g_offset=torch.as_tensor(g_tr.astype(dtype), device=w.device),
        ha_offset=torch.as_tensor(ha.astype(dtype), device=w.device),
        tri_centroids=torch.as_tensor(mesh.triangle_centroids.astype(dtype), device=w.device),
        tri_areas=torch.as_tensor(mesh.triangle_areas.astype(dtype), device=w.device),
        gtx_idx=gtx_idx,
        gtx_w=gtx_w,
        gty_idx=gty_idx,
        gty_w=gty_w,
    )


def film_sweep_data(model, film_name: str, brandt_diag=None) -> FilmSweepData:
    """Builds a film's :class:`FilmSweepData` from a factorized model.

    For a dense film, ``Q diag(w)`` is formed in place in the film's ``Q``
    buffer, which the film info then releases: the solve needs nothing
    else of ``Q``.  A low-memory film keeps no kernel (``Qw`` is None), and
    neither does a film with terminals, whose self-field is the in-film
    Biot-Savart sum.
    """
    device = model.device
    info = model.film_info[film_name]
    system = model.film_systems[film_name]
    mesh = device.meshes[film_name]
    torch_device = model.torch_device
    n = len(mesh.sites)
    dtype = info.sites.dtype
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
    gx_idx, gx_w = mesh.operators.gradient_x.to_gather(dtype, torch_device)
    gy_idx, gy_w = mesh.operators.gradient_y.to_gather(dtype, torch_device)
    terminal = film_name in device.terminals
    Qw = None
    if info.kernel is not None and not terminal:
        Qw = info.kernel.mul_(w[None, :])
    info.kernel = None
    if system.cg_op is None:
        factors, fac_kind = system.lu_piv, linalg.factor_kind(system.lu_piv)
    else:
        # A non-symmetric operator (inhomogeneous Lambda) needs BiCGStab.
        factors, fac_kind = None, "bicgstab" if system.cg_op["nonsym"] else "cg"
    return FilmSweepData(
        name=film_name,
        n=n,
        interior=torch.as_tensor(system.indices, device=torch_device),
        factors=factors,
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
        fac_kind=fac_kind,
        brandt_diag=brandt_diag,
        **_vortex_response(model, film_name),
        **(_terminal_fields(model, film_name) if terminal else {}),
    )


def _get_sweep_data(model) -> Dict[str, FilmSweepData]:
    """The model's per-film sweep tensors, ``model.film_data``, brought up
    to date with its vortices: after ``set_vortices`` only the vortex
    response columns are rebuilt (a dense film's ``Q`` buffer was consumed
    when the data was first built)."""
    snapshot = vortex_snapshot(model)
    if model.film_data_vortices != snapshot:
        model.film_data = {
            name: replace(data, **_vortex_response(model, name))
            for name, data in model.film_data.items()
        }
        model.film_data_vortices = snapshot
    return model.film_data


def _widened(data: FilmSweepData, dtype: torch.dtype) -> FilmSweepData:
    """``data`` with the operands of its self-field in ``dtype`` (float32
    entries are exact in float64), for streams delivered in another dtype
    than the film data's."""
    def cast(t):
        return None if t is None else t.to(dtype)

    return replace(
        data, sites=cast(data.sites), weights=cast(data.weights),
        tri_centroids=cast(data.tri_centroids), tri_areas=cast(data.tri_areas),
    )


@tracing.traced("sweep.self_field")
def _self_field_batch(data: FilmSweepData, g: torch.Tensor) -> torch.Tensor:
    """Self-field for ``g`` of shape ``(B, n)``: ``Q @ (w * g)`` as one
    product with ``Q diag(w)``, or on the low-memory path one matrix-free
    :func:`ops.kernels.Q_apply` over all ``B`` columns.  The stream of a
    film with terminals is nonzero on its boundary, so its self-field is
    the in-film Biot-Savart sum over triangle-centroid currents.

    Float64 streams on float32 film data (a polished sweep) take the same
    operators widened: the pairwise sums run in float64.  The dense
    float32 ``Q diag(w)`` is applied by :func:`ops.kernels.residual_f64`,
    which multiplies a float32 matrix with float64 columns in float64,
    for float32 streams too: the diagonal and the off-diagonal terms
    cancel to a small part of their sum, so a float32 product of ~20,000
    terms leaves errors of ~1e-4 of the self-field (``chip_smoke.py``
    phase 16); the kernel rounds the result once to the streams' dtype."""
    if g.dtype != data.weights.dtype:
        data = _widened(data, g.dtype)
    if data.terminal:
        Jtx = gather_matvec_batch(data.gty_idx, data.gty_w, g)
        Jty = -gather_matvec_batch(data.gtx_idx, data.gtx_w, g)
        return kernels.biot_savart_within_film(
            data.sites, data.tri_centroids, data.tri_areas, torch.stack([Jtx, Jty], dim=-1)
        )
    if data.brandt_diag is not None:
        wg = data.weights[None, :] * g
        return data.brandt_diag[None, :] * g - kernels.q_apply(data.sites, wg.T.contiguous()).T
    if data.Qw is None:
        return kernels.Q_apply(data.sites, data.weights, (data.weights[None, :] * g).T).T
    if data.Qw.dtype == torch.float32:
        # The kernel reads g^T in place; the CPU route multiplies a
        # row-major copy, as it always has (its BLAS sums a transposed
        # operand in another order).
        gT = g.T if g.is_cuda else g.T.contiguous()
        if isinstance(data.Qw, RowSharded):
            return data.Qw.residual_f64(gT, out_dtype=g.dtype).T
        return kernels.residual_f64(data.Qw, gT, out_dtype=g.dtype).T
    return (data.Qw @ g.T).T


def _interior_rhs(data: FilmSweepData, Hz_total, I_circ):
    """Fixed stream ``g0`` ``(B, n)`` (hole and transport values) and the
    interior right-hand side ``h`` ``(B, ni)`` of ``(-A) g = h``."""
    if data.hole_masks.shape[0]:
        g0 = I_circ @ data.hole_masks
        Ha_eff = I_circ @ data.hole_ha_vecs
    else:
        g0 = torch.zeros_like(Hz_total)
        Ha_eff = torch.zeros_like(Hz_total)
    if data.g_offset is not None:
        # 1-d offsets broadcast over B; 2-d ones are per sweep point.
        g0 = g0 + data.g_offset
        Ha_eff = Ha_eff + data.ha_offset
    return g0, (Hz_total - Ha_eff)[:, data.interior]


def _vortex_term(data: FilmSweepData, vortex_flux: float) -> torch.Tensor:
    """The vortices' part of the interior stream: ``(ni, 1)`` for shared
    amplitudes, ``(ni, B)`` for a per-point amplitude sweep."""
    eff = vortex_flux * data.vortex_scales * data.vortex_nphi0
    if eff.ndim == 1:
        return (data.vortex_cols @ eff)[:, None]
    return data.vortex_cols @ eff.T


def _check_inversion(name: str, A: torch.Tensor, h: torch.Tensor, gf: torch.Tensor) -> None:
    """Warns if the solved interior stream ``gf`` of film ``name`` does
    not reproduce the right-hand side ``h`` (both ``(ni, B)``): ``-A gf``
    must equal ``h`` within ``numpy.allclose``'s tolerances (``1e-8 +
    1e-5 |h|`` per entry).  The difference is the float64 residual
    ``h + A gf``."""
    r = linalg.system_residual(A, h.double(), gf.double())
    err = r.abs()
    if bool(tracing.to_host(torch.any(err > 1e-8 + 1e-5 * h.double().abs()))):
        logger.warning(
            f"Unable to solve for stream function in {name!r}, "
            f"maximum error {float(tracing.to_host(err.max())):.3e}."
        )


@tracing.traced("sweep.film_solve")
def _solve_film_batch(
    data: FilmSweepData,
    Hz_total: torch.Tensor,  # (B, n): applied + field from other films
    I_circ: torch.Tensor,  # (B, n_holes)
    vortex_flux: float,
    refine_steps: int = 2,
    check_inversion: bool = False,
):
    """Batched single-film solve.  Returns ``g`` ``(B, n)`` and ``J``
    ``(B, n, 2)``.  With ``check_inversion`` the solve of a materialized
    system is verified (see :func:`_check_inversion`)."""
    g0, h = _interior_rhs(data, Hz_total, I_circ)
    hT = h.T.contiguous()  # (ni, B)
    if data.fac_kind in ("cg", "bicgstab"):
        # The matrix-free solves control their own accuracy: no
        # refinement (and no A for it).
        gf = linalg.matrix_free_solve_host(data.cg_op, hT)
    else:

        def solve(rhs):
            return linalg.lu_solve(data.factors, rhs)

        if linalg.factors_dtype(data.factors) != data.A.dtype:
            # A high-precision film: float64 system, float32 factors.
            gf = linalg.refined_solve(
                data.A, linalg.mixed_preconditioner(data.factors, data.A.dtype), hT
            )
        else:
            gf = solve(hT)
            if refine_steps:
                gf = linalg.refine_safeguarded(solve, data.A, hT, gf, refine_steps)
        if check_inversion:
            _check_inversion(data.name, data.A, hT, gf)
    if data.vortex_cols is not None:
        gf = gf + _vortex_term(data, vortex_flux)
    # The interior indices are unique, so the scatter-add is exact.
    g = g0.index_add(1, data.interior, gf.T)
    Jx = gather_matvec_batch(data.gy_idx, data.gy_w, g)
    Jy = -gather_matvec_batch(data.gx_idx, data.gx_w, g)
    return g, torch.stack([Jx, Jy], dim=-1)


@tracing.traced("sweep.coupling")
def _coupling_round(
    film_data: Dict[str, FilmSweepData], films: List[str], streams, Js, Hz_applied,
    coupling: str = "exact",
):
    """One inter-film coupling exchange.  Returns the field each film feels
    from all others, ``{film: (B, n)}``.

    ``coupling="exact"``: over unordered film pairs, two one-way
    ``biot_savart_batch`` passes per pair, or one ``biot_savart_pair``
    pass with ``SUPERSCREEN_TPU_PAIR_COUPLING=1``, on the current
    densities ``Js``.  ``coupling="fft"``: each source's stream ``streams``
    is transformed once, and each destination sums its sources' transfers
    in Fourier space (one ``irfft2`` and one grid gather per film)."""
    if coupling == "fft":
        from .ops import fft_coupling

        spectra = {
            name: fft_coupling.fft_source_spectrum(film_data[name].fft_grid, streams[name])
            for name in films
        }
        new_others = {}
        for dst in films:
            srcs = [s for s in films if s != dst]
            dzs = [abs(film_data[dst].z0 - film_data[s].z0) for s in srcs]
            new_others[dst] = fft_coupling.fft_fields_from_spectra(
                film_data[dst].fft_grid, [spectra[s] for s in srcs], dzs
            )
        return new_others
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


def _batch_rows(data: FilmSweepData, b0: int, b1: int) -> FilmSweepData:
    """``data`` with its per-sweep-point fields (``(B, ...)`` vortex
    amplitudes and terminal offsets) cut to sweep points ``b0:b1``."""
    cut = {
        f: getattr(data, f)[b0:b1]
        for f in ("vortex_nphi0", "g_offset", "ha_offset")
        if getattr(data, f) is not None and getattr(data, f).ndim == 2
    }
    return replace(data, **cut) if cut else data


def _row_part(value, r: int, b0: int, b1: int, device) -> torch.Tensor:
    """Sweep points ``b0:b1`` of an input, data row ``r``'s part of a
    :class:`parallel.sharding.DataSharded` or a slice of a tensor or
    array, on ``device``."""
    if isinstance(value, DataSharded):
        if value.bounds[r] != (b0, b1):
            raise ValueError(
                f"Data row {r} holds sweep points {value.bounds[r]}, the film data's "
                f"split expects {(b0, b1)}."
            )
        return value.parts[r]
    t = value if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))
    return t[b0:b1].to(device)


def _run_data_rows(runner, film_data: ShardedFilmData, Hz_applied, I_circ, *args,
                   batch_axis: int = 0, **kwargs):
    """``runner`` (the single-device sweep) once per data row of
    ``film_data``'s mesh, on the row's replica and its slice of the sweep
    points (:func:`parallel.rows.row_bounds`), and the per-film results
    concatenated on the batch axis on ``mesh.devices[0, 0]``.  No row
    waits for another: on distinct cards the rows overlap, except where a
    matrix-free film reads its residual on the host."""
    mesh = film_data.mesh
    B = next(iter(Hz_applied.values())).shape[0]
    outs = []
    for r, (b0, b1) in enumerate(row_bounds(B, mesh.shape["data"])):
        if b1 == b0:
            continue
        device = mesh.devices[r, 0]
        outs.append(runner(
            {name: _batch_rows(d, b0, b1) for name, d in film_data.rows[r].items()},
            {name: _row_part(v, r, b0, b1, device) for name, v in Hz_applied.items()},
            {name: _row_part(v, r, b0, b1, device) for name, v in I_circ.items()},
            *args, **kwargs,
        ))
    home = mesh.devices[0, 0]
    return tuple(
        {name: torch.cat([out[i][name].to(home) for out in outs], dim=batch_axis) for name in outs[0][i]}
        for i in range(len(outs[0]))
    )


def _inner_refine_steps(refine_steps: int) -> int:
    """Refinement steps for the *inner* self-consistent rounds of a sweep
    that keeps only its final state: 0 unless
    ``SUPERSCREEN_TPU_INNER_REFINE`` says otherwise (clamped to
    ``refine_steps``).  The inter-film coupling is a weak contraction, so
    solver noise in the intermediate iterates is damped, and only the final
    round's solve, which keeps the full ``refine_steps``, sets the
    delivered residual."""
    env = os.environ.get("SUPERSCREEN_TPU_INNER_REFINE")
    if env is None:
        return 0
    requested = int(env)
    if requested > refine_steps:
        logger.warning(
            "SUPERSCREEN_TPU_INNER_REFINE=%d clamped to refine_steps=%d "
            "(inner rounds never refine more than the final round); "
            "raise refine_steps to honor the override.",
            requested, refine_steps,
        )
    return min(requested, refine_steps)


def _run_sweep(
    film_data, Hz_applied, I_circ, vortex_flux: float, iterations: int, refine_steps: int,
    coupling: str = "exact", *, keep_history: bool = False, check_inversion: bool = False,
):
    """The initial per-film solves, ``iterations`` coupling rounds each
    followed by the film solves, and the self-fields.

    Without ``keep_history`` only the final state is kept: the initial
    solves and all but the last round refine with
    :func:`_inner_refine_steps`, the last round with ``refine_steps``, and
    the self-field is computed once, from the final streams.  Returns
    ``streams (B, n)``, ``Js (B, n, 2)``, ``self_fields (B, n)`` and
    ``others (B, n)`` per film.

    With ``keep_history`` every round refines ``refine_steps`` times and is
    kept: the same per-film dicts with a leading history axis of length
    ``iterations + 1`` (``others[0]`` is zero: the initial solve sees only
    the applied field), and the self-field one batched product per film
    over the whole history.

    ``check_inversion`` checks every film solve (:func:`_check_inversion`).
    Film data placed on a mesh (:func:`parallel.sharding.sharded_film_data`)
    runs once per data row (:func:`_run_data_rows`)."""
    if isinstance(film_data, ShardedFilmData):
        return _run_data_rows(
            _run_sweep, film_data, Hz_applied, I_circ, vortex_flux, iterations, refine_steps,
            coupling, keep_history=keep_history, check_inversion=check_inversion,
            batch_axis=1 if keep_history else 0,
        )
    films = list(film_data)
    inner_refine = refine_steps
    if iterations >= 1 and not keep_history:
        inner_refine = _inner_refine_steps(refine_steps)
    streams, Js, history = {}, {}, []
    others = {name: torch.zeros_like(Hz_applied[name]) for name in films}
    for it in range(max(iterations, 0) + 1):
        if it:
            others = _coupling_round(film_data, films, streams, Js, Hz_applied, coupling)
        for name in films:
            streams[name], Js[name] = _solve_film_batch(
                film_data[name],
                Hz_applied[name] + others[name] if it else Hz_applied[name],
                I_circ[name],
                vortex_flux,
                refine_steps if it == iterations else inner_refine,
                check_inversion,
            )
        if keep_history:
            history.append((dict(streams), dict(Js), others))
    if keep_history:
        streams, Js, others = (
            {name: torch.stack([kept[k][name] for kept in history]) for name in films}
            for k in range(3)
        )
    # One batched self-field product per film, over the whole history if
    # it is kept.
    self_fields = {
        name: _self_field_batch(film_data[name], g.reshape(-1, g.shape[-1])).reshape(g.shape)
        for name, g in streams.items()
    }
    return streams, Js, self_fields, others


def relative_residual(
    data: FilmSweepData, Hz_total, I_circ, g, vortex_flux: float = 0.0
) -> torch.Tensor:
    """Relative residual ``||h + A g_int|| / ||h||`` of a film's interior
    system for a solved stream ``g`` ``(B, n)``, one value per batch row.
    A matrix-free film has no ``A``: its product is applied matrix-free, in
    float64 (the true residual of the stored operator).
    What the solve adds to its solution is taken out first: the transport
    stream of a film with terminals and the vortices' part (with
    ``vortex_flux`` as the solve used it)."""
    g0, h = _interior_rhs(data, Hz_total, I_circ)
    g_int = (g - g0)[:, data.interior].T
    if data.vortex_cols is not None:
        g_int = g_int - _vortex_term(data, vortex_flux)
    if data.A is None:
        r = (h.T.double() + linalg.brandt_matvec64(data.cg_op, g_int)).to(h.dtype)
    else:
        r = linalg.system_residual(data.A, h.T.contiguous(), g_int)
    return torch.linalg.vector_norm(r, dim=0) / torch.linalg.vector_norm(h.T, dim=0)


class SweepResult:
    """Results of a batched sweep: stacked per-film NumPy arrays, from
    which :meth:`solution` materializes a full :class:`Solution` for any
    sweep index.

    Args:
        model: The factorized model used for the sweep.
        streams: ``{film_name: (B, n)}`` stream functions.
        current_densities: ``{film_name: (B, n, 2)}``.
        self_fields: ``{film_name: (B, n)}`` in ``field_units``.
        applied_fields: ``{film_name: (B, n)}`` in ``field_units``.
        other_fields: ``{film_name: (B, n)}`` in ``field_units`` (or None).
        field_units, current_units: Units of the stored arrays.
        applied_field_funcs: The per-point applied field callables (if any).
        circulating_currents: The per-point circulating currents (or None:
            the model's).
        vortex_nPhi0: ``(B, n_vortices)`` per-point amplitudes in flat film
            order (or None: the declared ones).
        terminal_currents: The per-point transport drives (or None: the
            model's).

    ``final_refine_report`` holds the report of the float64 polish when
    the sweep was run with ``final_refine`` (see
    :func:`superscreen_tpu_torch.certify.refine_sweep_f64`), else None.
    """

    def __init__(
        self,
        *,
        model,
        streams: Dict[str, np.ndarray],
        current_densities: Dict[str, np.ndarray],
        self_fields: Dict[str, np.ndarray],
        applied_fields: Dict[str, np.ndarray],
        other_fields: Optional[Dict[str, np.ndarray]],
        field_units: str,
        current_units: str,
        applied_field_funcs: Optional[Sequence[Callable]] = None,
        circulating_currents: Optional[Sequence[Dict[str, float]]] = None,
        vortex_nPhi0: Optional[np.ndarray] = None,
        terminal_currents: Optional[Sequence[Dict[str, Dict[str, float]]]] = None,
    ):
        self.model = model
        self.streams = streams
        self.current_densities = current_densities
        self.self_fields = self_fields
        self.applied_fields = applied_fields
        self.other_fields = other_fields
        self.field_units = field_units
        self.current_units = current_units
        self.applied_field_funcs = applied_field_funcs
        self.circulating_currents = circulating_currents
        self.vortex_nPhi0 = vortex_nPhi0
        self.terminal_currents = terminal_currents
        self.final_refine_report = None

    @property
    def num_solutions(self) -> int:
        return next(iter(self.streams.values())).shape[0]

    def __len__(self) -> int:
        return self.num_solutions

    def solution(self, index: int) -> Solution:
        """Materializes the full :class:`Solution` for sweep index ``index``
        (the arrays are copies)."""
        film_solutions = {
            name: FilmSolution(
                stream=np.array(self.streams[name][index]),
                current_density=np.array(self.current_densities[name][index]),
                applied_field=np.array(self.applied_fields[name][index]),
                self_field=np.array(self.self_fields[name][index]),
                field_from_other_films=(
                    None
                    if self.other_fields is None
                    else np.array(self.other_fields[name][index])
                ),
            )
            for name in self.streams
        }
        applied_func = ConstantField(0)
        if self.applied_field_funcs is not None:
            applied_func = self.applied_field_funcs[index]
        circ = self.model.circulating_currents
        if self.circulating_currents is not None:
            circ = self.circulating_currents[index]
        vortices = [v for vs in self.model.vortices.values() for v in vs]
        if self.vortex_nPhi0 is not None:
            vortices = [
                Vortex(x=v.x, y=v.y, film=v.film, nPhi0=float(a))
                for v, a in zip(vortices, self.vortex_nPhi0[index])
            ]
        terminal = self.model.terminal_currents
        if self.terminal_currents is not None:
            terminal = self.terminal_currents[index]
        return Solution(
            device=self.model.device,
            film_solutions=film_solutions,
            applied_field_func=applied_func,
            field_units=self.field_units,
            current_units=self.current_units,
            circulating_currents=circ,
            terminal_currents=terminal,
            vortices=vortices,
            solver="superscreen_tpu_torch.solve_many",
            torch_device=self.model.torch_device,
        )

    def solutions(self) -> List[Solution]:
        """Materializes all Solutions."""
        return [self.solution(i) for i in range(self.num_solutions)]


@tracing.traced("sweep.terminals")
def _apply_terminal_sweeps(model, film_data, terminal_currents, B: int, current_units: str):
    """Folds a length-B terminal-current sweep into ``film_data``: each
    terminal film's ``g_offset``/``ha_offset`` become ``(B, n)`` built from
    per-terminal unit bootstrap solutions.

    The bootstrap is affine in the drive: the raw boundary stream is linear
    in the terminal currents, the centering then shifts it by the
    drive-dependent scalar ``c = -max + ptp/2`` (over the raw array,
    interior zeros included), and the remaining solves are linear in the
    boundary values.  So each sweep point is
    ``sum_k coeff_k S(b_k) + c S(1_boundary)``: ``n_terminals`` solves per
    film in all, independent of B.  Returns the updated film_data and the
    per-point float dicts (for the materialized Solutions)."""
    from .solver.solve_film import solve_from_boundary_stream, terminal_boundary_stream
    from .solver.utils import currents_to_floats

    device = model.device
    if len(terminal_currents) != B:
        raise ValueError(
            f"terminal_currents must have length B={B}, got {len(terminal_currents)}."
        )
    per_point = []
    for tc in terminal_currents:
        d = {}
        for film, currents in (tc or {}).items():
            if film not in device.terminals:
                raise ValueError(f"Film {film!r} has no terminals.")
            d[film] = currents_to_floats(currents, device.ureg, current_units)
        per_point.append(d)

    out = dict(film_data)
    for film, terms in device.terminals.items():
        names = [t.name for t in terms]
        T = len(names)
        drive = np.zeros((B, T))
        for b, d in enumerate(per_point):
            cur = d.get(film, {})
            unknown = set(cur) - set(names)
            if unknown:
                raise ValueError(f"Unknown terminals for film {film!r}: {sorted(unknown)}.")
            for j, nm in enumerate(names):
                drive[b, j] = cur.get(nm, 0.0)
            total = drive[b].sum()
            if abs(total) > 1e-9 * max(1.0, np.abs(drive[b]).max()):
                raise ValueError(
                    f"Terminal currents for film {film!r} at sweep point {b} do not "
                    f"sum to zero (sum = {total:.3e})."
                )
        if T < 2:
            raise ValueError(f"Film {film!r} needs >= 2 terminals for a transport sweep.")
        info = model.film_info[film]
        tsys = model.terminal_systems[film]
        mesh = device.meshes[film]
        data = out[film]

        def unit_solution(boundary_stream):
            g_u = solve_from_boundary_stream(device, info, tsys, boundary_stream)
            return g_u, _terminal_boundary_ha(
                mesh.sites, info.boundary_indices, g_u, data.weights
            )

        # Raw (uncentered) boundary streams of the T-1 basis drives
        # (e_k - e_last), their solved unit solutions, plus the solution
        # for a constant unit boundary stream (the centering direction).
        raw_b, units_g, units_h = [], [], []
        for k in range(T - 1):
            basis = dict.fromkeys(names, 0.0)
            basis[names[k]] = 1.0
            basis[names[-1]] = -1.0
            raw_b.append(terminal_boundary_stream(device, info, tsys, basis))
            g_u, h_u = unit_solution(raw_b[-1])
            units_g.append(g_u)
            units_h.append(h_u)
        ones_b = np.zeros(len(mesh.sites))
        ones_b[info.boundary_indices] = 1.0
        g_c, h_c = unit_solution(ones_b)
        units_g.append(g_c)
        units_h.append(h_c)
        coeff = drive[:, :-1]  # the currents sum to zero: T-1 independent ones
        # The per-point centering scalar over the raw superposed array
        # (interior zeros included), exactly as in
        # solve_for_terminal_current_stream; c = 0 for a zero drive.
        raw = coeff @ np.stack(raw_b)  # (B, n)
        c = -raw.max(axis=1) + np.ptp(raw, axis=1) / 2.0
        c = np.where(np.all(coeff == 0.0, axis=1), 0.0, c)
        coeff = np.concatenate([coeff, c[:, None]], axis=1)  # (B, T)
        like = (data.weights.device, data.weights.dtype)
        out[film] = replace(
            data,
            g_offset=tracing.to_device(coeff @ np.stack(units_g), *like),
            ha_offset=tracing.to_device(coeff @ np.stack(units_h), *like),
        )
    return out, per_point


@tracing.traced("sweep.vortices")
def _apply_vortex_amplitudes(model, film_data, vortex_nPhi0, B: int):
    """Folds per-sweep-point vortex amplitudes into ``film_data`` (each
    film's ``vortex_nphi0`` becomes ``(B, n_v)``).  Returns the updated
    film_data and the flat ``(B, n_total)`` amplitude array (film order)."""
    dtype = model.device.solve_dtype
    counts = {name: len(vs) for name, vs in model.vortices.items()}
    if isinstance(vortex_nPhi0, dict):
        per_film = {}
        for name, n_v in counts.items():
            arr = np.asarray(vortex_nPhi0.get(name, np.zeros((B, 0))), dtype=dtype)
            if arr.shape != (B, n_v):
                raise ValueError(
                    f"vortex_nPhi0[{name!r}] must have shape ({B}, {n_v}), got {arr.shape}."
                )
            per_film[name] = arr
        unknown = set(vortex_nPhi0) - set(counts)
        if unknown:
            raise ValueError(f"vortex_nPhi0 names unknown films: {unknown}.")
    else:
        arr = np.asarray(vortex_nPhi0, dtype=dtype)
        n_total = sum(counts.values())
        if arr.shape != (B, n_total):
            raise ValueError(
                f"vortex_nPhi0 must have shape ({B}, {n_total}), got {arr.shape}."
            )
        per_film, offset = {}, 0
        for name, n_v in counts.items():
            per_film[name] = arr[:, offset : offset + n_v]
            offset += n_v
    out = dict(film_data)
    for name, amps in per_film.items():
        if amps.shape[1]:
            out[name] = replace(
                out[name],
                vortex_nphi0=tracing.to_device(
                    np.ascontiguousarray(amps), out[name].weights.device
                ),
            )
    flat = np.concatenate([per_film[name] for name in counts], axis=1)
    return out, flat


def _applied_field_rows(device, model, applied_fields: Sequence[Callable]) -> Dict[str, np.ndarray]:
    """Each film's ``(B, n)`` applied field, from B callables evaluated at
    its mesh sites and layer height."""
    out = {}
    for name, mesh in device.meshes.items():
        n = len(mesh.sites)
        z0 = device.layers[model.film_info[name].layer].z0 * np.ones(n)
        out[name] = np.stack(
            [
                np.broadcast_to(
                    np.squeeze(np.asarray(f(mesh.sites[:, 0], mesh.sites[:, 1], z0))), (n,)
                )
                for f in applied_fields
            ],
            axis=0,
        )
    return out


#: Per-round cost-model constants of ``coupling="auto"``, from
#: ``chip_smoke.py`` phase 12 (B = 8, float32) on an NVIDIA H100 80GB HBM3
#: at its 700.00 W power limit: one exact and one FFT round in turns on
#: five layouts (the four-ring stack at 27,298 sites per film, pairs of
#: disks at ~12,000, ~30,000 and ~100,000 sites per film, the Huber
#: susceptometer; PERF.md).  Exact: ms per ``n_src * n_dst`` site pair of
#: one ``biot_savart_batch`` pass plus a fixed cost per ordered film pair
#: (its launches), fitted on the five.  FFT, per film: the larger of a
#: fixed cost, fitted on the five (the round's ~35 launches per film pace
#: it: the card is idle ~80 % of an FFT round on the stack), and the
#: device's work, ms per ``G^2 log2(G)`` (the device time of the stack's
#: FFT rounds under the profiler, G = 864).  The JAX package's constants
#: were measured on a TPU v5e and its model has no fixed costs, so it
#: switches to the FFT transfer at other sizes than the port does.
_EXACT_MS_PER_PAIR_SITE2 = 9.789e-10
_EXACT_MS_PER_FILM_PAIR = 0.0794
_FFT_MS_PER_FILM = 0.9217
_FFT_DEVICE_MS_PER_GRID_UNIT = 4.944e-8


def _predict_fft_grid(device) -> int:
    """The grid size the FFT coupling would build (``ops.fft_coupling``'s
    grid with the default spacing and padding)."""
    from .ops.fft_coupling import _grid_axes, mean_edge_spacing

    meshes = device.meshes
    x, _, _ = _grid_axes([m.sites for m in meshes.values()], mean_edge_spacing(meshes))
    return len(x)


def _coupling_round_ms(sizes, G) -> Dict[str, float]:
    """The cost model's ms of one exact and one FFT coupling round over
    films of ``sizes`` sites on an FFT grid of side ``G``."""
    n_films = len(sizes)
    fft_device_ms = _FFT_DEVICE_MS_PER_GRID_UNIT * G * G * np.log2(G)
    return {
        "exact": _EXACT_MS_PER_PAIR_SITE2 * (sum(sizes) ** 2 - sum(n * n for n in sizes))
        + _EXACT_MS_PER_FILM_PAIR * n_films * (n_films - 1),
        "fft": n_films * max(_FFT_MS_PER_FILM, fft_device_ms),
    }


def _distinct_heights(model, films) -> bool:
    z0s = [model.device.layers[model.film_info[f].layer].z0 for f in films]
    return len(set(np.round(z0s, 12))) == len(z0s)


def _resolve_auto_coupling(model, films, iterations) -> str:
    """The concrete coupling mode for ``coupling="auto"``.

    "exact" with one film, with no coupling rounds, or with two films at
    one height (the analytic transfer suppresses nothing at ``dz = 0``).
    ``SUPERSCREEN_TPU_FFT_COUPLING_MIN_N`` restores a plain threshold: FFT
    iff every film has at least that many sites.  Otherwise the per-round
    cost models of :func:`_coupling_round_ms` decide: the exact pairwise
    pass costs ``A * sum_{i != j} n_i n_j + E * n_films (n_films - 1)``,
    the FFT transfer ``n_films * max(F, C * G^2 log2(G))`` for the grid
    ``G`` the FFT path would build, with the constants measured on the
    H100 (see ``_EXACT_MS_PER_PAIR_SITE2``).  The JAX package's model has
    no fixed costs and its constants were fitted on a TPU, so it chooses
    differently: on the card two disks switch to FFT at ~30,000 sites per
    film.
    """
    if len(films) < 2 or iterations == 0 or not _distinct_heights(model, films):
        return "exact"
    device = model.device
    sizes = [len(device.meshes[f].sites) for f in films]
    threshold = os.environ.get("SUPERSCREEN_TPU_FFT_COUPLING_MIN_N")
    if threshold is not None:
        return "fft" if min(sizes) >= int(threshold) else "exact"
    ms = _coupling_round_ms(sizes, _predict_fft_grid(device))
    return "fft" if ms["fft"] < ms["exact"] else "exact"


def _attach_fft_grids(model, film_data, films) -> Dict[str, FilmSweepData]:
    """``film_data`` with each film's FFT grid data.  The grids depend only
    on the geometry, so they are built once per model (on its torch
    device) and cached on it.  Raises for films at one height."""
    from .ops.fft_coupling import build_film_grid_data

    if not _distinct_heights(model, films):
        raise ValueError(
            "coupling='fft' requires films on distinct layer heights (the analytic "
            "transfer suppresses no wavenumbers at dz=0); use coupling='exact'."
        )
    if model.fft_grids is None:
        model.fft_grids = build_film_grid_data(model.device, model.torch_device)
    return {name: replace(d, fft_grid=model.fft_grids[name]) for name, d in film_data.items()}


def _check_coupling(coupling: str) -> None:
    if coupling not in ("auto", "exact", "fft"):
        raise ValueError(f"coupling must be 'auto', 'exact', or 'fft' (got {coupling!r}).")


def _resolve_coupling(model, films, iterations, coupling: str) -> str:
    """The coupling mode a solve runs: ``"auto"`` resolved, and ``"fft"``
    only where a coupling round runs (several films, ``iterations > 0``)."""
    _check_coupling(coupling)
    if coupling == "auto":
        coupling = _resolve_auto_coupling(model, films, iterations)
    if len(films) < 2 or iterations == 0:
        return "exact"
    return coupling


@dataclass
class _DeviceSweep:
    """A sweep's results on the torch device, as :func:`_sweep_on_device`
    leaves them: ``outputs``, ``(streams, Js, self_fields, others)`` as
    :func:`_run_sweep` returns them; the float64 polish's ``report``; the
    flat ``(B, n_vortices)`` amplitudes of a ``vortex_nPhi0`` sweep; the
    per-point ``terminal_currents`` as floats (each None where not asked
    for)."""

    outputs: tuple
    report: Optional[dict] = None
    vortex_nPhi0: Optional[np.ndarray] = None
    terminal_currents: Optional[list] = None

    def to_host(self, field_conversion: float, result_dtype=None, applied=None):
        """The results half of :func:`solve_many` and
        :func:`superscreen_tpu_torch.solve`: ``outputs`` and, where given,
        the applied fields ``applied`` (``{film: (B, n)}`` tensors) as host
        NumPy arrays, all copied inside the one ``sweep.to_host`` span.  The
        streams, current densities and self-fields are then cast to
        ``result_dtype`` (where given), and the field quantities divided by
        ``field_conversion`` into the caller's units, once per film
        array."""
        tensors = self.outputs if applied is None else (*self.outputs, applied)
        with tracing.span("sweep.to_host"):
            host = [{name: tracing.to_host(t).numpy() for name, t in d.items()} for d in tensors]
        if result_dtype is not None:
            host[:3] = (
                {name: a.astype(result_dtype, copy=False) for name, a in d.items()}
                for d in host[:3]
            )
        inv = 1.0 / field_conversion
        host[2:] = ({name: a * inv for name, a in d.items()} for d in host[2:])
        return host


def _sweep_on_device(
    model, Hz, I_circ, *, iterations: int, refine_steps: int, coupling: str,
    keep_history: bool = False, check_inversion: bool = False, vortex_nPhi0=None,
    terminal_currents=None, mesh=None, final_refine: int = 0, result_dtype=None,
) -> _DeviceSweep:
    """The sweep from its drive on the torch device to its results there,
    as :func:`solve_many` and :func:`superscreen_tpu_torch.solve` share it:
    the coupling resolved, the model's film data with the FFT grids, the
    per-point vortex amplitudes and terminal drives folded in and placed on
    ``mesh``'s data rows, the rounds of :func:`_run_sweep`, and the float64
    polish of ``final_refine`` steps
    (:func:`superscreen_tpu_torch.certify.refine_sweep_f64`).  ``Hz``
    ``{film: (B, n)}`` and ``I_circ`` ``{film: (B, n_holes)}`` are in
    solver units on the model's torch device."""
    from .solver.solve import highest_matmul_precision

    films = list(model.device.films)
    B = next(iter(Hz.values())).shape[0]
    coupling = _resolve_coupling(model, films, iterations, coupling)
    report = vortex_amps = term_dicts = None
    with highest_matmul_precision():
        film_data = _get_sweep_data(model)
        if coupling == "fft":
            film_data = _attach_fft_grids(model, film_data, films)
        if vortex_nPhi0 is not None:
            film_data, vortex_amps = _apply_vortex_amplitudes(model, film_data, vortex_nPhi0, B)
        if terminal_currents is not None:
            film_data, term_dicts = _apply_terminal_sweeps(
                model, film_data, terminal_currents, B, model.current_units
            )
        run_data = film_data
        if mesh is not None:
            from .parallel.sharding import sharded_film_data

            run_data = sharded_film_data(film_data, mesh, pad_to_shardable=False)
        outputs = _run_sweep(
            run_data, Hz, I_circ, vortex_flux_quantum(model.device, model.current_units),
            iterations, refine_steps, coupling, keep_history=keep_history,
            check_inversion=check_inversion,
        )
        if final_refine:
            from .certify import refine_sweep_f64, sweep_outputs_from_streams

            streams, _, _, others = outputs
            streams, report = refine_sweep_f64(
                film_data, streams, others if len(films) > 1 and iterations > 0 else None,
                Hz, I_circ, steps=final_refine, result_dtype=result_dtype or "float64",
            )
            # Current densities and self-fields follow the polished streams.
            outputs = (streams, *sweep_outputs_from_streams(film_data, streams), others)
    return _DeviceSweep(outputs, report, vortex_amps, term_dicts)


@tracing.traced("solve_many", entry=True)
def solve_many(
    device=None,
    *,
    model=None,
    applied_fields: Optional[Sequence[Callable]] = None,
    applied_field_arrays: Optional[Dict[str, Union[np.ndarray, torch.Tensor]]] = None,
    circulating_currents: Optional[Sequence[Dict[str, Union[float, str]]]] = None,
    terminal_currents: Optional[Sequence[Dict[str, Dict[str, Union[float, str]]]]] = None,
    vortices: Optional[Sequence[Vortex]] = None,
    field_units: str = "mT",
    current_units: str = "uA",
    iterations: int = 0,
    refine_steps: int = 2,
    sharding=None,
    coupling: str = "auto",
    keep_history: bool = False,
    vortex_nPhi0: Optional[Union[np.ndarray, Dict[str, np.ndarray]]] = None,
    final_refine: int = 0,
    result_dtype: Optional[str] = None,
    torch_device="cuda",
) -> Union[SweepResult, List[SweepResult]]:
    """Solves a batch of models that share one factorization.

    Exactly one of ``applied_fields`` (a sequence of B field callables) or
    ``applied_field_arrays`` (``{film_name: (B, n)}`` pre-evaluated fields
    in ``field_units``) must describe the sweep, and
    ``circulating_currents``, ``terminal_currents`` and ``vortex_nPhi0``
    may vary per point.  All B points are solved at once against each
    film's factorization.

    Args:
        device: The device to solve (or provide ``model``).
        model: A pre-factorized model.
        applied_fields: B applied-field callables ``H_z(x, y, z)``.
        applied_field_arrays: ``{film_name: (B, n)}`` applied fields, NumPy
            arrays or torch tensors (a tensor on the model's device is used
            where it is).
        circulating_currents: Length-B sequence of ``{hole_name: current}``.
        terminal_currents: Length-B sequence of
            ``{film_name: {terminal_name: current}}`` transport drives
            (each summing to zero per film): a bias sweep.  The terminal
            bootstrap is linear in the drive, so the whole sweep reuses
            ``n_terminals`` unit bootstrap solutions per film; when given,
            it replaces any drive baked into the model at factorization.
        vortices: Vortices (positions fixed across the sweep; amplitudes
            may vary per point via ``vortex_nPhi0``).  Only with ``device``;
            a ``model`` carries its own.
        field_units: Units of the applied field.
        current_units: Units for currents.
        iterations: Self-consistent inter-film coupling rounds.
        refine_steps: Iterative-refinement steps of the final round's
            solves (and of every round with ``keep_history``).  The inner
            rounds refine 0 times unless ``SUPERSCREEN_TPU_INNER_REFINE``
            says otherwise: their solver noise is contracted by the
            coupling iteration.
        sharding: A :class:`parallel.sharding.NamedSharding` whose spec
            starts with ``"data"`` (``batch_sharding(make_mesh(...))``),
            its devices all of ``torch_device``'s type: the sweep points
            are split over the mesh's data rows, each row solves its part
            against its own replica of the film data (``Q diag(w)`` and
            ``A`` row-sharded over the row's model slots), and the
            results are gathered before the :class:`SweepResult`.
            Composes with every other option.
        coupling: Inter-film coupling operator of the rounds: ``"auto"``
            (the per-round cost model of :func:`_resolve_auto_coupling`,
            fitted on the H100, so it may choose otherwise than the JAX
            package), ``"exact"`` (pairwise Biot-Savart) or ``"fft"``
            (the analytic Fourier transfer of :mod:`.ops.fft_coupling`;
            films on distinct heights; its error is the JAX package's, up
            to ~2e-2 of the streams on a ring with a circulating current,
            whose hole the grid leaves empty).
        keep_history: Record every self-consistent iteration and return a
            list of ``iterations + 1`` :class:`SweepResult` objects (one
            per iteration, each covering the whole batch) instead of just
            the final state.
        vortex_nPhi0: Per-sweep-point vortex amplitudes, overriding each
            vortex's declared ``nPhi0``: a ``(B, n_vortices)`` array
            ordered like the flattened ``vortices`` grouped by film, or
            ``{film_name: (B, n_film_vortices)}``.  Rows of one-hot
            amplitudes sweep the vortex position over the declared
            candidate sites in one batched solve; integer rows sweep
            winding-number states.
        final_refine: Float64 polish steps after the sweep (see
            :func:`superscreen_tpu_torch.certify.refine_sweep_f64`): the
            final per-film systems are re-refined on the torch device with
            a float64 residual, the current densities and self-fields are
            recomputed from the polished streams, and all three are
            delivered in float64 unless ``result_dtype`` says otherwise.
            The report is ``SweepResult.final_refine_report``.  Matrix-free
            and vortex films are left as solved.  Not with
            ``keep_history``.
        result_dtype: dtype of the delivered streams, current densities and
            self-fields (default: the device's ``solve_dtype``, or float64
            with ``final_refine``).  Not with ``keep_history``.
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``.  A given ``model`` must live on this device.

    Returns:
        A :class:`SweepResult`, or a list of them if ``keep_history``.
    """
    from .solver.solve import factorize_model, resolve_torch_device
    from .solver.utils import currents_to_floats, field_conversion_factor, torch_dtype

    torch_device = resolve_torch_device(torch_device)
    mesh = None
    if sharding is not None:
        from .parallel.sharding import batch_mesh

        mesh = batch_mesh(sharding, torch_device)
    if model is None:
        if device is None:
            raise ValueError("Either a model or a device must be provided.")
        model = factorize_model(
            device=device,
            current_units=current_units,
            vortices=vortices,
            torch_device=torch_device,
        )
    elif vortices is not None:
        raise ValueError(
            "If model is provided, vortices must be None: bake them in with "
            "factorize_model(vortices=...) or model.set_vortices(...)."
        )
    elif model.torch_device != torch_device:
        raise ValueError(f"The model lives on {model.torch_device}, not on {torch_device}.")
    if final_refine and keep_history:
        raise ValueError(
            "final_refine is not supported with keep_history=True (polish "
            "applies to the final state only)."
        )
    if result_dtype is not None and keep_history:
        raise ValueError(
            "result_dtype is not supported with keep_history=True (the "
            "history path stores the sweep's native dtype)."
        )
    device = model.device
    current_units = model.current_units
    dtype = device.solve_dtype
    tdtype = torch_dtype(dtype)
    films = list(device.films)
    field_conversion = field_conversion_factor(
        field_units, current_units, length_units=device.length_units, ureg=device.ureg
    ).magnitude

    # The applied fields as (B, n) tensors per film, in solver units.
    if (applied_fields is None) == (applied_field_arrays is None):
        raise ValueError("Provide exactly one of applied_fields or applied_field_arrays.")
    with tracing.span("sweep.inputs"):
        Hz_applied = {}
        if applied_field_arrays is not None:
            applied_field_funcs = None
            for name in films:
                arr = applied_field_arrays[name]
                if not isinstance(arr, torch.Tensor):
                    arr = torch.as_tensor(np.asarray(arr, dtype=dtype))
                n = len(device.meshes[name].sites)
                if arr.ndim != 2 or arr.shape[1] != n:
                    raise ValueError(
                        f"applied_field_arrays[{name!r}] must have shape (B, {n}), "
                        f"got {tuple(arr.shape)}."
                    )
                Hz_applied[name] = tracing.to_device(arr, torch_device, tdtype) * field_conversion
            batch_sizes = {name: a.shape[0] for name, a in Hz_applied.items()}
            if len(set(batch_sizes.values())) > 1:
                raise ValueError(
                    f"applied_field_arrays must share one batch size across films, got {batch_sizes}."
                )
            B = next(iter(batch_sizes.values()))
        else:
            applied_field_funcs = list(applied_fields)
            B = len(applied_field_funcs)
            for name, rows in _applied_field_rows(device, model, applied_field_funcs).items():
                Hz_applied[name] = tracing.to_device(rows.astype(dtype) * field_conversion, torch_device)

        # Circulating currents: (B, n_holes) per film.
        circ_dicts = None
        if circulating_currents is not None:
            if len(circulating_currents) != B:
                raise ValueError(
                    f"circulating_currents must have length B={B}, got {len(circulating_currents)}."
                )
            circ_dicts = [
                currents_to_floats(c, device.ureg, current_units) for c in circulating_currents
            ]
        I_circ = {
            name: tracing.to_device(
                [
                    [c.get(h, 0.0) for h in model.film_info[name].hole_indices]
                    for c in (circ_dicts or [model.circulating_currents] * B)
                ],
                torch_device,
                tdtype,
            ).reshape(B, len(model.film_info[name].hole_indices))
            for name in films
        }
    swept = _sweep_on_device(
        model, Hz_applied, I_circ, iterations=iterations, refine_steps=refine_steps,
        coupling=coupling, keep_history=keep_history, vortex_nPhi0=vortex_nPhi0,
        terminal_currents=terminal_currents, mesh=mesh, final_refine=final_refine,
        result_dtype=result_dtype,
    )
    multi = len(films) > 1 and iterations > 0
    with tracing.span("sweep.results"):
        streams, Js, self_fields, others, applied_host = swept.to_host(
            field_conversion, result_dtype, Hz_applied
        )

        def result(pick) -> SweepResult:
            return SweepResult(
                model=model,
                streams={name: pick(a) for name, a in streams.items()},
                current_densities={name: pick(a) for name, a in Js.items()},
                self_fields={name: pick(a) for name, a in self_fields.items()},
                applied_fields=applied_host,
                other_fields={name: pick(a) for name, a in others.items()} if multi else None,
                field_units=field_units,
                current_units=current_units,
                applied_field_funcs=applied_field_funcs,
                circulating_currents=circ_dicts,
                vortex_nPhi0=swept.vortex_nPhi0,
                terminal_currents=swept.terminal_currents,
            )

        if keep_history:
            return [result(lambda a, it=it: a[it]) for it in range(iterations + 1)]
        final = result(lambda a: a)
        final.final_refine_report = swept.report
        return final

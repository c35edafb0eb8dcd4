"""Float64 certification and polish of finished sweeps, on the card.

Counterpart of ``superscreen_tpu/certify.py``.  The film systems are
stored and factorized in float32; the H100 has native float64, so the
residuals, the refinement and the polished streams all live on the torch
device of the film data, and only a handful of sampled rows and the
per-point norms reach the host.

* :func:`certify_sweep` computes, for every film and sweep point, the
  float64 relative residual ``||A g + h|| / ||h||`` of the final
  self-consistent system through :func:`ops.kernels.residual_f64` (the
  float32 ``A`` read once, products and sums in float64), refines the
  streams in float64 through the film's own float32 factorization to
  report the forward error of the float32 solves
  (``refined_stream_delta_max``) and the attainable floor
  (``refined_residual_rel_max``), and checks the device residual against
  an independent NumPy float64 recomputation on ``n_sample_rows`` rows of
  ``A`` gathered to the host.
* :func:`refine_sweep_f64` is the same refinement as a delivery path: the
  polish behind ``solve_many(final_refine=...)``.
* :func:`sweep_outputs_from_streams` recomputes current densities and
  self-fields from (possibly float64) polished streams.

Matrix-free films have no materialized system and are skipped with a
note; so are vortex films, as in the JAX package (their response columns
add rank-one terms outside the plain linear system).  ``"inv"`` and
``"chol"`` films are certified like LU films, as the JAX package's
certificate treats them: the correction is solved by the product ``M r``
(row by row for a film inverted over a mesh, its residual formed on each
slot's rows of ``A``) or by ``-cho_solve(L, r) / w``.
"""

import time
from typing import Dict, Optional

import numpy as np
import torch

from .ops import linalg
from .ops.fem import gather_matvec_batch
from .ops.rows import RowSharded

__all__ = ["certify_sweep", "refine_sweep_f64", "sweep_outputs_from_streams"]

# Why a film is skipped: the kind (refine_sweep_f64's note) and the reason
# (certify_sweep's note adds it in brackets).
_MATRIX_FREE = ("matrix-free film", "no materialized system")
_VORTEX = ("vortex film", "rank-1 response terms outside the plain linear system")


def _skipped(data):
    """The ``(kind, reason)`` for which a film is left out, or None."""
    if data.A is None or data.fac_kind in ("cg", "bicgstab"):
        return _MATRIX_FREE
    if data.vortex_cols is not None:
        return _VORTEX
    return None


def _on_device(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (tensor or array) on the device of ``like``, its dtype kept."""
    return torch.as_tensor(value).to(like.device)


def _film_rhs_and_streams(data, streams, others, Hz, I_circ):
    """The film's final interior streams ``G`` and effective right-hand
    side ``H`` (both ``(ni, B)`` float64, on the device) such that the
    solved system is ``(-A) G = H``: the residual is ``H + A G``.

    Mirrors ``sweep._interior_rhs``: hole circulating currents and
    transport-terminal drives enter as stream and effective-field offsets
    (``g_offset``/``ha_offset``: ``(n,)`` fixed, or ``(B, n)`` for a swept
    terminal film) that are taken out before comparing against the
    interior system.  The rank-one products are formed in the film data's
    dtype, as the solve formed them, and widened; the sums are float64.
    """
    w = data.weights
    streams = _on_device(streams, w)
    B = streams.shape[0]
    g0 = torch.zeros(streams.shape, dtype=torch.float64, device=w.device)
    Ha_eff = torch.zeros_like(g0)
    if data.hole_masks.shape[0] and I_circ is not None:
        I_circ = _on_device(I_circ, w).to(w.dtype).reshape(B, data.hole_masks.shape[0])
        g0 = g0 + (I_circ @ data.hole_masks).double()
        Ha_eff = Ha_eff + (I_circ @ data.hole_ha_vecs).double()
    if data.g_offset is not None:
        # 1-d offsets broadcast over B; 2-d ones are per sweep point.
        g0 = g0 + data.g_offset.double()
        Ha_eff = Ha_eff + data.ha_offset.double()
    Hz_total = _on_device(Hz, w).double()
    if others is not None:
        Hz_total = Hz_total + _on_device(others, w).double()
    G = (streams.double() - g0)[:, data.interior].T.contiguous()
    H = (Hz_total - Ha_eff)[:, data.interior].T.contiguous()
    return G, H


def _refine(data, G, H, R, steps: int):
    """``steps`` rounds of ``G += solve(R)`` with the correction solved
    through the film's factorization (``(-A) x = rhs``, in the factors'
    dtype) and the residual in float64.  Returns the refined ``G`` and its
    residual."""
    dtype = linalg.factors_dtype(data.factors)
    for _ in range(steps):
        G = G + linalg.lu_solve(data.factors, R.to(dtype)).double()
        R = linalg.system_residual(data.A, H, G)
    return G, R


def _rel_max(R, h_norms) -> float:
    return float(torch.max(torch.linalg.vector_norm(R, dim=0) / h_norms))


def refine_sweep_f64(
    film_data,
    streams: Dict[str, torch.Tensor],
    others: Optional[Dict[str, torch.Tensor]],
    Hz_applied: Dict[str, torch.Tensor],
    I_circ: Optional[Dict[str, torch.Tensor]] = None,
    steps: int = 2,
    result_dtype: Optional[str] = None,
):
    """Float64 final polish of finished sweep streams.

    The in-sweep refinement delivers float32 streams; this pass re-refines
    only the final per-film systems, with the float64 residual of
    :func:`certify_sweep` and the correction solved through the film's own
    float32 factorization, without touching the self-consistent loop.

    Args:
        film_data: ``{film_name: FilmSweepData}``.
        streams: ``{film_name: (B, n)}`` final streams (tensors or arrays).
        others: ``{film_name: (B, n)}`` final field from the other films,
            or None.
        Hz_applied: ``{film_name: (B, n)}`` applied fields (solver units).
        I_circ: ``{film_name: (B, n_holes)}`` circulating currents (None:
            zero).
        steps: Refinement steps.
        result_dtype: dtype of the returned streams.  ``"float64"`` keeps
            the polished iterate; None keeps the input streams' dtype,
            which for a float32 sweep casts the iterate back and floors
            the delivered residual at the float32 representation limit.

    Returns:
        ``(polished_streams, report)``: ``{film: (B, n)}`` tensors on the
        film data's device with the interior entries replaced by the
        refined solution, and the residuals before and after per film.
        Matrix-free and vortex films come back unchanged (cast to
        ``result_dtype``) and noted.
    """
    from .solver.utils import torch_dtype

    report = {
        "steps": int(steps),
        "residual_rel_max_before": 0.0,
        "residual_rel_max_after": 0.0,
        "per_film": {},
    }
    out_dtype = None if result_dtype is None else torch_dtype(result_dtype)
    polished = {}
    for name, data in film_data.items():
        g_in = _on_device(streams[name], data.weights)
        dtype_here = g_in.dtype if out_dtype is None else out_dtype
        polished[name] = g_in.to(dtype_here)
        skipped = _skipped(data)
        if skipped is not None:
            report["per_film"][name] = f"{skipped[0]}: skipped"
            continue
        G, H = _film_rhs_and_streams(
            data, g_in, None if others is None else others[name], Hz_applied[name],
            None if I_circ is None else I_circ[name],
        )
        R = linalg.system_residual(data.A, H, G)
        h_norms = torch.linalg.vector_norm(H, dim=0)
        rel_before = _rel_max(R, h_norms)
        G64, R = _refine(data, G, H, R, steps)
        rel_after = _rel_max(R, h_norms)
        # The offsets are already inside the streams: only the interior
        # solution changes.  The interior indices are unique.
        delta = (G64 - G).T.to(dtype_here)
        polished[name] = polished[name].index_add(1, data.interior, delta)
        report["per_film"][name] = {
            "residual_rel_before": float(f"{rel_before:.3e}"),
            "residual_rel_after": float(f"{rel_after:.3e}"),
        }
        report["residual_rel_max_before"] = max(report["residual_rel_max_before"], rel_before)
        report["residual_rel_max_after"] = max(report["residual_rel_max_after"], rel_after)
    return polished, report


def sweep_outputs_from_streams(film_data, streams: Dict[str, torch.Tensor]):
    """Current densities and self-fields from (possibly float64) polished
    streams, in the streams' dtype.

    The gradient and self-field operators are the film data's own (float32
    entries are exact when widened), so outputs derived from float64
    streams carry the operators' float32 assembly error but none of the
    float32 solution rounding: ``J`` and the self-field stay plain linear
    images of the delivered stream.

    Returns ``(current_densities, self_fields)`` keyed like ``streams``.
    """
    from .sweep import _self_field_batch

    Js, self_fields = {}, {}
    for name, data in film_data.items():
        g = _on_device(streams[name], data.weights)
        Jx = gather_matvec_batch(data.gy_idx, data.gy_w, g)
        Jy = -gather_matvec_batch(data.gx_idx, data.gx_w, g)
        Js[name] = torch.stack([Jx, Jy], dim=-1)
        self_fields[name] = _self_field_batch(data, g)
    return Js, self_fields


def certify_sweep(
    film_data,
    streams: Dict[str, torch.Tensor],
    others: Optional[Dict[str, torch.Tensor]],
    Hz_applied: Dict[str, torch.Tensor],
    I_circ: Optional[Dict[str, torch.Tensor]] = None,
    refine_steps: int = 3,
    n_sample_rows: int = 512,
    budget_s: Optional[float] = None,
    seed: int = 42,
) -> dict:
    """Certifies the accuracy of a finished sweep at full scale.

    Args:
        film_data: ``{film_name: FilmSweepData}`` (``model.film_data``, or
            the per-sweep copy that carries swept terminal offsets).
        streams: ``{film_name: (B, n)}`` final stream functions (solver
            units; tensors or arrays).
        others: ``{film_name: (B, n)}`` final field from the other films
            (None for uncoupled solves).
        Hz_applied: ``{film_name: (B, n)}`` applied fields (solver units).
        I_circ: ``{film_name: (B, n_holes)}`` circulating currents (None:
            zero).
        refine_steps: Float64 refinement rounds used to estimate the
            forward error of the float32 solves.
        n_sample_rows: Rows of ``A`` gathered to the host for the
            independent NumPy float64 check (0 disables it).
        budget_s: Optional wall-clock budget; films are certified until it
            is exhausted (at least one film always completes).
        seed: Seed of the sampled rows.

    Returns:
        A dict with ``residual_rel_per_film`` / ``residual_rel_max``
        (float64 relative residuals of the delivered streams, per sweep
        point and their maximum), ``refined_stream_delta_max`` (distance of
        the delivered streams to the float64-refined ones),
        ``refined_residual_rel_max`` (the floor after refinement),
        ``sampled_row_rel_disagreement`` (device against host float64
        residual on the sampled rows, relative to ``||h||``), and
        bookkeeping (films certified, seconds per film, skip notes).  An
        error in a film raises.
    """
    t_start = time.perf_counter()
    out = {
        "residual_rel_per_film": {},
        "residual_rel_max": 0.0,
        "refined_stream_delta_max": 0.0,
        "refined_residual_rel_max": 0.0,
        "sampled_row_rel_disagreement": 0.0,
        "n_sample_rows": int(n_sample_rows),
        "films_certified": [],
        "film_seconds": {},
        "method": (
            "device-resident f64: residual_f64 over the f32 system (products and "
            "sums in f64); f64 refinement through the f32 factorization; "
            f"independent host f64 check on {n_sample_rows} gathered rows"
        ),
    }
    rng = np.random.default_rng(seed)
    for name, data in film_data.items():
        elapsed = time.perf_counter() - t_start
        if out["films_certified"] and budget_s is not None and elapsed > budget_s:
            out["budget_note"] = (
                f"budget {budget_s:.0f}s exhausted after {elapsed:.0f}s; "
                f"certified {len(out['films_certified'])}/{len(film_data)} films"
            )
            break
        skipped = _skipped(data)
        if skipped is not None:
            out.setdefault("films_skipped", {})[name] = f"{skipped[0]} ({skipped[1]})"
            continue
        t_film = time.perf_counter()
        G, H = _film_rhs_and_streams(
            data, streams[name], None if others is None else others[name], Hz_applied[name],
            None if I_circ is None else I_circ[name],
        )
        R = linalg.system_residual(data.A, H, G)
        h_norms = torch.linalg.vector_norm(H, dim=0)
        rel = (torch.linalg.vector_norm(R, dim=0) / h_norms).cpu().numpy()
        out["residual_rel_per_film"][name] = [float(f"{v:.3e}") for v in rel]
        out["residual_rel_max"] = max(out["residual_rel_max"], float(np.max(rel)))
        out["films_certified"].append(name)
        # Independent host check on a handful of gathered rows of A.
        if n_sample_rows:
            ni = data.A.shape[0]
            rows = np.sort(rng.choice(ni, size=min(n_sample_rows, ni), replace=False))
            rows_t = torch.as_tensor(rows, device=data.A.device)
            A_rows = (
                data.A.take_rows(rows_t) if isinstance(data.A, RowSharded) else data.A[rows_t]
            ).cpu().numpy().astype(np.float64)
            r_host = A_rows @ G.cpu().numpy() + H[rows_t].cpu().numpy()
            r_dev = R[rows_t].cpu().numpy()
            disagreement = float(
                np.max(np.linalg.norm(r_host - r_dev, axis=0) / h_norms.cpu().numpy())
            )
            out["sampled_row_rel_disagreement"] = max(
                out["sampled_row_rel_disagreement"], disagreement
            )
        # Float64 refinement through the film's factorization: forward error.
        if refine_steps:
            G64, Rr = _refine(data, G, H, R, refine_steps)
            delta = torch.linalg.vector_norm(G - G64, dim=0) / torch.linalg.vector_norm(
                G64, dim=0
            )
            out["refined_residual_rel_max"] = max(
                out["refined_residual_rel_max"], _rel_max(Rr, h_norms)
            )
            out["refined_stream_delta_max"] = max(
                out["refined_stream_delta_max"], float(torch.max(delta))
            )
        if data.A.device.type == "cuda":
            torch.cuda.synchronize(data.A.device)
        out["film_seconds"][name] = round(time.perf_counter() - t_film, 2)
    return out

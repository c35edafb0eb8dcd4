"""Scanning SQUID microscopy: a susceptometer rastered over a sample, each
scan one batched computation on the torch device.

Counterpart of ``superscreen_tpu/squids/scanning.py``.  A susceptibility scan
(:func:`susceptibility_scan`) is, in the first-order approximation:

1. the susceptometer solved once on its own with its field-coil drive,
   its sheet currents frozen;
2. the field those currents apply to the sample at every scan position
   (:func:`applied_field_maps`: Biot-Savart sums through the
   ``biot_savart_batch`` kernel, kept on the torch device);
3. the sample's response at all ``B`` positions as one
   :func:`superscreen_tpu_torch.solve_many` sweep sharing one
   factorization;
4. the response flux through the pickup loop, the line integral of the
   sample currents' vector potential around the shifted contour.

``back_action`` adds rounds of SQUID <-> sample self-consistency;
:func:`magnetometry_scan` images a solved sample's own currents, with the
SQUID body's screening if asked; :func:`build_scan_forward` is the
first-order scan as a function of the sample's parameters that
``torch.autograd`` differentiates.

Conventions: the SQUID keeps its own frame; its ``z = 0`` plane sits
``squid_height`` above the sample's, and its origin is rastered over
``positions`` (sample length units).  Only squared layer separations
enter.  Every entry point computes on ``torch_device`` (``"cuda"`` by
default, which raises without a card; ``"cpu"`` takes the plain PyTorch
versions of the kernels).
"""

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import tracing
from ..device.device import Device  # noqa: F401  (in the namespace, as in the JAX package)
from ..ops import kernels
from ..solution import Solution
from ..solver import FactorizedModel, factorize_model
from ..solver.solve import resolve_torch_device
from ..solver.utils import torch_dtype
from ..units import ureg as _global_ureg

__all__ = [
    "applied_field_maps",
    "build_scan_forward",
    "magnetometry_scan",
    "susceptibility_scan",
]


def _ccw(points: np.ndarray) -> np.ndarray:
    """Closed CCW copy of a polygonal contour."""
    pts = np.asarray(points, dtype=float)
    if not np.allclose(pts[0], pts[-1]):
        pts = np.concatenate([pts, pts[:1]], axis=0)
    x, y = pts[:, 0], pts[:, 1]
    area2 = np.sum(x[:-1] * y[1:] - x[1:] * y[:-1])
    if area2 < 0:
        pts = pts[::-1]
    return pts


def _length_factor(from_units: str, to_units: str) -> float:
    return float(_global_ureg(f"1 {from_units}").to(to_units).magnitude)


def _tensor(array, dtype, torch_device) -> torch.Tensor:
    """A NumPy array or a tensor as a tensor of ``dtype`` on the device."""
    if torch.is_tensor(array):
        return tracing.to_device(array, torch_device, torch_dtype(dtype))
    return tracing.to_device(np.array(array, dtype=dtype), torch_device)


def _readout_tensors(dev, contours, heights, torch_device, block: int = 16) -> Dict[str, torch.Tensor]:
    """``{film: (Bc, n, 2)}`` float64 readout tensors of closed contours:
    the trapezoid-rule flux of ``(A / mu_0) . dl`` around contour ``b`` of
    sheet currents ``J_b`` is ``sum_films sum_i R[b, i] . J_b[i]``
    (:func:`_readout_flux`), with ``R[b, i] = w_i / (4 pi) sum_k u_k /
    r(c_bk, site_i)`` over the vertices ``c_bk`` of ``contours[b]``
    (``(k + 1, 2)``, closed) at height ``heights[b]`` (a scalar or
    ``(Bc,)``), and ``u_k = (dl_{k-1} + dl_k) / 2`` the vertex weights of
    the closed contour.  A vertex on a site drops that site's term, as
    :func:`ops.kernels.vector_potential_2d` does (the ``1/r`` singularity
    is integrable).  Formed on ``torch_device`` in blocks of ``block``
    contours."""
    f64 = dict(dtype=torch.float64, device=torch_device)
    pts = tracing.to_device(np.array(contours, dtype=float), torch_device, torch.float64)  # (Bc, k + 1, 2)
    Bc = pts.shape[0]
    dl = pts[:, 1:] - pts[:, :-1]  # (Bc, k, 2)
    u = 0.5 * (dl + torch.roll(dl, 1, dims=1))
    verts = pts[:, :-1]
    zs = tracing.to_device(
        np.array(np.broadcast_to(heights, (Bc,)), dtype=float), torch_device, torch.float64
    )
    R = {}
    for name, mesh in dev.meshes.items():
        z_s = float(dev.layers[dev.films[name].layer].z0)
        sites = tracing.to_device(mesh.sites, torch_device, torch.float64)
        w = tracing.to_device(mesh.vertex_areas, torch_device, torch.float64)
        out = torch.empty((Bc, sites.shape[0], 2), **f64)
        for lo in range(0, Bc, block):
            c = verts[lo : lo + block]
            d2 = (
                (c[:, :, None, 0] - sites[None, None, :, 0]) ** 2
                + (c[:, :, None, 1] - sites[None, None, :, 1]) ** 2
                + ((zs[lo : lo + block] - z_s) ** 2)[:, None, None]
            )  # (b, k, n)
            positive = d2 > 0
            rinv = torch.where(positive, torch.rsqrt(torch.where(positive, d2, 1.0)), 0.0)
            out[lo : lo + block] = torch.einsum("bkn,bkx->bnx", rinv, u[lo : lo + block])
        R[name] = out * (w[None, :, None] / (4 * np.pi))
    return R


def _readout_flux(R: Dict[str, torch.Tensor], Js: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``(Bc,)`` flux ``sum_films sum_i R[b, i] . J_b[i]`` of readout
    tensors ``R`` (:func:`_readout_tensors`) and currents ``Js[film]`` of
    shape ``(Bc, n, 2)`` (varying with the contour) or ``(n, 2)`` (one
    distribution seen from every contour)."""
    return sum(torch.sum(R[name] * Js[name], dim=(-2, -1)) for name in R)


@tracing.traced("scan.readout")
def _contour_flux(dev, Js, contours, heights, torch_device) -> np.ndarray:
    """The flux of ``(A / mu_0) . dl`` (trapezoid rule) of the sheet
    currents ``Js[film]`` around each of ``contours`` ``(Bc, k + 1, 2)`` at
    ``heights`` (scalar or ``(Bc,)``), in float64 on ``torch_device``."""
    R = _readout_tensors(dev, contours, heights, torch_device)
    Js = {name: _tensor(Js[name], np.float64, torch_device) for name in R}
    return tracing.to_host(_readout_flux(R, Js)).numpy()


def _resolve_heights(squid_height, B: int, dtype=float) -> np.ndarray:
    """Validates a scalar-or-``(B,)`` scan-height spec and returns it as an
    array (0-d for a scalar)."""
    heights = np.asarray(squid_height, dtype=dtype)
    if heights.ndim not in (0, 1) or (heights.ndim == 1 and heights.shape != (B,)):
        raise ValueError(
            f"squid_height must be a scalar or shape ({B},), got {np.shape(squid_height)}."
        )
    return heights


def _pickup_contour(squid, pickup_loop, length_units):
    """A pickup-loop spec as a closed CCW contour in ``length_units`` and
    the loop's layer height (0 for a bare coordinate array)."""
    lf = _length_factor(squid.length_units, length_units)
    z_loop = 0.0
    if isinstance(pickup_loop, str):
        for group in (squid.holes, squid.films, squid.abstract_regions):
            if pickup_loop in group:
                poly = group[pickup_loop]
                contour = poly.points
                if poly.layer is not None:
                    z_loop = float(squid.layers[poly.layer].z0) * lf
                break
        else:
            raise KeyError(f"Polygon {pickup_loop!r} not found in SQUID device {squid.name!r}.")
    else:
        contour = np.asarray(pickup_loop, dtype=float)
    return _ccw(contour) * lf, z_loop


def _gather_squid_sheets(
    squid_solution: Solution, length_units: str, current_units: str
) -> Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, float]]:
    """Per-film ``(sites, areas, J, z0)`` of the frozen SQUID currents in the
    scan's length and current units."""
    squid = squid_solution.device
    lf = _length_factor(squid.length_units, length_units)
    cf = float(_global_ureg(f"1 {squid_solution.current_units}").to(current_units).magnitude)
    sheets = []
    for name, film in squid.films.items():
        mesh = squid.meshes[name]
        J = np.asarray(squid_solution.film_solutions[name].current_density)
        sheets.append(
            (
                np.asarray(mesh.sites) * lf,
                np.asarray(mesh.vertex_areas) * lf**2,
                J * (cf / lf),
                float(squid.layers[film.layer].z0) * lf,
            )
        )
    return sheets


@tracing.traced("scan.maps")
def applied_field_maps(
    sample_device,
    squid_solution: Solution,
    positions: np.ndarray,
    *,
    squid_height: Union[float, np.ndarray],
    current_units: str,
    torch_device="cuda",
) -> Dict[str, torch.Tensor]:
    """``{sample_film: (B, n)}`` ``H_z`` applied by the frozen SQUID currents
    at every scan position, in ``current_units / sample length_units``, as
    tensors on ``torch_device`` (``solve_many`` takes them as they are).

    A scalar ``squid_height`` is one ``biot_savart_batch`` launch per
    (SQUID film, sample film) over all ``B * n`` shifted points; a ``(B,)``
    array of heights (approach curves, tilted planes) is one launch per
    position.
    """
    torch_device = resolve_torch_device(torch_device)
    positions = np.atleast_2d(np.asarray(positions, dtype=float))
    B = positions.shape[0]
    dtype = sample_device.solve_dtype
    heights = _resolve_heights(squid_height, B, dtype)
    sheets = [
        (*(_tensor(a, dtype, torch_device) for a in sheet[:3]), sheet[3])
        for sheet in _gather_squid_sheets(squid_solution, sample_device.length_units, current_units)
    ]
    out = {}
    for film_name, mesh in sample_device.meshes.items():
        z_s = float(sample_device.layers[sample_device.films[film_name].layer].z0)
        sites = np.asarray(mesh.sites, dtype=dtype)
        n = sites.shape[0]
        # Shifting the SQUID by +p equals evaluating at sites - p.
        eval_pts = _tensor(sites[None, :, :] - positions[:, None, :], dtype, torch_device)
        H = torch.zeros((B, n), dtype=eval_pts.dtype, device=torch_device)
        for sq_sites, sq_areas, sq_J, sq_z0 in sheets:
            dz2 = ((heights + sq_z0 - z_s) ** 2).astype(dtype)
            if heights.ndim == 0:
                H += kernels.biot_savart_film_to_film_dz2(
                    sq_sites, sq_areas, sq_J, eval_pts.reshape(B * n, 2), float(dz2)
                ).reshape(B, n)
            else:
                for b in range(B):
                    H[b] += kernels.biot_savart_film_to_film_dz2(
                        sq_sites, sq_areas, sq_J, eval_pts[b], float(dz2[b])
                    )
        out[film_name] = H
    return out


def _cross_field_maps(
    *, src_dev, src_Js, dst_dev, dst_z_offset, shifts, dtype, torch_device
) -> Dict[str, torch.Tensor]:
    """``{dst_film: (B, n_dst)}`` ``H_z`` at the destination device's sites
    from the source currents, the destination shifted laterally by
    ``shifts[b]`` relative to the source frame: one ``biot_savart_batch``
    launch per position and film pair.

    ``src_Js[film]`` is ``(B, n_src, 2)`` (per-position currents) or
    ``(n_src, 2)`` (one distribution seen from every shift).
    ``dst_z_offset`` is the height of the destination's ``z = 0`` plane
    above the source's (scalar or ``(B,)``).  Both devices share length
    units.
    """
    shifts = np.asarray(shifts, dtype=dtype)
    B = shifts.shape[0]
    z_off = np.broadcast_to(np.asarray(dst_z_offset, dtype=dtype), (B,))
    sources = [
        (
            _tensor(src_mesh.sites, dtype, torch_device),
            _tensor(src_mesh.vertex_areas, dtype, torch_device),
            _tensor(src_Js[src_name], dtype, torch_device),
            float(src_dev.layers[src_dev.films[src_name].layer].z0),
        )
        for src_name, src_mesh in src_dev.meshes.items()
    ]
    out = {}
    for dst_name, dst_mesh in dst_dev.meshes.items():
        z_dst = z_off + float(dst_dev.layers[dst_dev.films[dst_name].layer].z0)
        dst_sites = np.asarray(dst_mesh.sites, dtype=dtype)
        eval_pts = _tensor(dst_sites[None, :, :] + shifts[:, None, :], dtype, torch_device)
        H = torch.zeros(eval_pts.shape[:2], dtype=eval_pts.dtype, device=torch_device)
        for sites, areas, J, z_src in sources:
            dz2 = np.ascontiguousarray((z_dst - z_src) ** 2, dtype=dtype)
            for b in range(B):
                H[b] += kernels.biot_savart_film_to_film_dz2(
                    sites, areas, J if J.ndim == 2 else J[b], eval_pts[b], float(dz2[b])
                )
        out[dst_name] = H
    return out


def _factorize_squid(
    squid_solution, current_units, field_units, coupling, iterations, torch_device,
    sharding=None,
):
    """The SQUID factorized with its drive (in ``current_units``) and its
    zero-applied-field currents, solved through the same batched path as
    the back-action rounds."""
    from ..sweep import solve_many

    squid = squid_solution.device
    cf = float(_global_ureg(f"1 {squid_solution.current_units}").to(current_units).magnitude)
    circulating = {k: v * cf for k, v in (squid_solution.circulating_currents or {}).items()}
    terminal = {
        film: {t: v * cf for t, v in d.items()}
        for film, d in (squid_solution.terminal_currents or {}).items()
    }
    model = factorize_model(
        device=squid,
        current_units=current_units,
        terminal_currents=terminal or None,
        circulating_currents=circulating or None,
        vortices=list(squid_solution.vortices or []) or None,
        torch_device=torch_device,
    )
    zeros = {
        name: np.zeros((1, len(mesh.sites)), dtype=squid.solve_dtype)
        for name, mesh in squid.meshes.items()
    }
    base = solve_many(
        model=model, applied_field_arrays=zeros, field_units=field_units,
        current_units=current_units, iterations=iterations, coupling=coupling,
        sharding=sharding, torch_device=torch_device,
    )
    return model, {name: base.current_densities[name][0] for name in squid.meshes}


@tracing.traced("susceptibility_scan", entry=True)
def susceptibility_scan(
    sample_device=None,
    *,
    sample_model: Optional[FactorizedModel] = None,
    squid_solution: Solution,
    positions: np.ndarray,
    squid_height: Union[float, np.ndarray],
    pickup_loop: Union[str, np.ndarray],
    I_fc: Union[str, float],
    iterations: int = 0,
    back_action: int = 0,
    coupling: str = "auto",
    current_units: str = "uA",
    units: str = "Phi_0 / A",
    with_units: bool = False,
    batch_size: Optional[int] = None,
    sharding=None,
    torch_device="cuda",
) -> np.ndarray:
    """The sample-response susceptibility map of a scanning SQUID.

    Args:
        sample_device: The meshed sample (or pass ``sample_model``).
        sample_model: A pre-factorized sample model (reused across scans;
            it must live on ``torch_device``).
        squid_solution: The susceptometer solved standalone with its
            field-coil drive; its sheet currents are frozen for the scan
            (re-solved per position if ``back_action > 0``).
        positions: ``(B, 2)`` positions of the SQUID origin over the
            sample, in sample length units.
        squid_height: Height of the SQUID's ``z = 0`` plane above the
            sample's (sample length units): a scalar, or ``(B,)``.
        pickup_loop: Name of a polygon of the SQUID device, or a ``(k, 2)``
            contour in SQUID coordinates.
        I_fc: The field-coil current of ``squid_solution`` (normalizes the
            map): a string with units or a float in amperes.
        iterations: Coupling rounds for multi-film samples.
        back_action: Rounds of SQUID <-> sample self-consistency (0: the
            SQUID currents are frozen).  Each round re-solves the driven
            SQUID at all positions in one sweep under the sample's field,
            then the sample.  The devices must share length units.
        coupling: Inter-film coupling of the sweeps (see
            :func:`superscreen_tpu_torch.solve_many`).
        current_units: Working current units of the sample solve (the
            model's when ``sample_model`` is given).
        units: Output units (default ``Phi_0 / A``).
        with_units: Return a Quantity array instead of floats.
        batch_size: Positions per sweep (default: all at once).
        sharding: Optional batch sharding of the scan's sweeps (a
            :class:`superscreen_tpu_torch.parallel.sharding.NamedSharding`,
            see :func:`superscreen_tpu_torch.solve_many`): the positions of
            each sweep are split over the mesh's data rows.
        torch_device: ``"cuda"`` (default) or ``"cpu"``.

    Returns:
        ``(B,)`` response mutual inductance ``Phi_pickup / I_fc`` in
        ``units`` (negative for a diamagnetic sample).
    """
    from ..parallel.sharding import batch_mesh
    from ..sweep import solve_many

    torch_device = resolve_torch_device(torch_device)
    if sharding is not None:
        batch_mesh(sharding, torch_device)  # refuse a bad sharding before any work
    if (sample_device is None) == (sample_model is None):
        raise ValueError("Provide exactly one of sample_device or sample_model.")
    if sample_model is None:
        sample_model = factorize_model(
            device=sample_device, current_units=current_units, torch_device=torch_device
        )
    else:
        current_units = sample_model.current_units
    device = sample_model.device
    length_units = device.length_units
    dtype = device.solve_dtype
    if batch_size is not None and batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}.")

    positions = np.atleast_2d(np.asarray(positions, dtype=float))
    B = positions.shape[0]
    squid = squid_solution.device
    contour, z_loop = _pickup_contour(squid, pickup_loop, length_units)
    heights = _resolve_heights(squid_height, B)
    z_pl = heights + z_loop

    field_units = f"{current_units} / {length_units}"
    mu0_flux = _global_ureg(f"1 mu_0 * {current_units} * {length_units}")
    I_amp = (_global_ureg(I_fc) if isinstance(I_fc, str) else I_fc * _global_ureg("A")).to("A")
    out = np.zeros(B, dtype=float)
    sweep = dict(
        field_units=field_units, current_units=current_units, iterations=iterations,
        coupling=coupling, sharding=sharding, torch_device=torch_device,
    )

    squid_model = squid_base_J = None
    if back_action > 0:
        if squid.length_units != length_units:
            raise ValueError(
                "back_action > 0 requires the SQUID and sample devices to share length "
                f"units (got {squid.length_units!r} vs {length_units!r})."
            )
        squid_model, squid_base_J = _factorize_squid(
            squid_solution, current_units, field_units, coupling, iterations, torch_device,
            sharding,
        )

    for start in range(0, B, batch_size or B):
        chunk = positions[start : start + (batch_size or B)]
        Bc = chunk.shape[0]
        h_chunk = heights if heights.ndim == 0 else heights[start : start + Bc]
        z_chunk = z_pl if np.ndim(z_pl) == 0 else z_pl[start : start + Bc]
        H = applied_field_maps(
            device, squid_solution, chunk, squid_height=h_chunk, current_units=current_units,
            torch_device=torch_device,
        )
        result = solve_many(model=sample_model, applied_field_arrays=H, **sweep)
        squid_J = None
        for _ in range(back_action):
            # The sample currents' field at the shifted SQUID sites, then a
            # batched re-solve of the driven SQUID under it, then the field
            # of its re-screened currents back on the sample.
            H_squid = _cross_field_maps(
                src_dev=device, src_Js=result.current_densities, dst_dev=squid,
                dst_z_offset=h_chunk, shifts=chunk, dtype=dtype, torch_device=torch_device,
            )
            squid_result = solve_many(model=squid_model, applied_field_arrays=H_squid, **sweep)
            squid_J = squid_result.current_densities
            H_sample = _cross_field_maps(
                src_dev=squid, src_Js=squid_J, dst_dev=device, dst_z_offset=-h_chunk,
                shifts=-chunk, dtype=dtype, torch_device=torch_device,
            )
            result = solve_many(model=sample_model, applied_field_arrays=H_sample, **sweep)

        # Sample-current flux through the shifted pickup contour.
        pts = contour[None, :, :] + chunk[:, None, :]
        flux = _contour_flux(device, result.current_densities, pts, z_chunk, torch_device)
        if squid_J is not None:
            # The SQUID's own re-screened currents, in the SQUID frame,
            # where the contour is fixed.
            dJ = {name: squid_J[name] - squid_base_J[name][None] for name in squid_J}
            pts_sq = np.broadcast_to(contour[None], (Bc,) + contour.shape)
            flux = flux + _contour_flux(squid, dJ, pts_sq, z_loop, torch_device)
        M = (flux * mu0_flux / I_amp).to(units)
        out[start : start + Bc] = M.magnitude
    if with_units:
        return out * _global_ureg(units)
    return out


def magnetometry_scan(
    sample_solution: Solution,
    *,
    positions: np.ndarray,
    squid_height: Union[float, np.ndarray],
    pickup_loop: Union[str, np.ndarray],
    squid_device=None,
    screening: bool = False,
    iterations: int = 0,
    coupling: str = "auto",
    units: str = "Phi_0",
    with_units: bool = False,
    batch_size: Optional[int] = None,
    sharding=None,
    torch_device="cuda",
) -> np.ndarray:
    """Scanning-SQUID magnetometry image of a solved sample: the flux of
    the sample's own sheet currents (vortices, circulating, transport and
    screening currents) through the pickup loop at every position, the
    line integral of their vector potential around the shifted contour.

    With ``screening=True`` the SQUID body's screening response to the
    sample's field is solved at every position in one sweep (one
    factorization of the undriven SQUID), and the flux of those currents
    through the loop is added.

    Args:
        sample_solution: The solved sample.
        positions: ``(B, 2)`` positions of the SQUID origin (sample length
            units).
        squid_height: Height of the SQUID's ``z = 0`` plane above the
            sample's: scalar or ``(B,)``.
        pickup_loop: Polygon name in ``squid_device``, or a ``(k, 2)``
            contour (SQUID coordinates with ``squid_device``, else sample
            length units at the SQUID's ``z = 0`` plane).
        squid_device: The meshed SQUID (for a named loop and for
            ``screening``).
        screening: Include the SQUID body's screening response (the
            devices must share length units).
        iterations: Coupling rounds of the SQUID's screening solve.
        coupling: Coupling operator of that sweep.
        units: Output flux units (default ``Phi_0``).
        with_units: Return a Quantity array instead of floats.
        batch_size: Positions per chunk.
        sharding: Optional batch sharding of the screening sweep (see
            :func:`susceptibility_scan`).
        torch_device: ``"cuda"`` (default) or ``"cpu"``.

    Returns:
        ``(B,)`` pickup-loop flux in ``units``.
    """
    from ..parallel.sharding import batch_mesh
    from ..sweep import solve_many

    torch_device = resolve_torch_device(torch_device)
    if sharding is not None:
        batch_mesh(sharding, torch_device)  # refuse a bad sharding before any work
    device = sample_solution.device
    length_units = device.length_units
    current_units = sample_solution.current_units
    dtype = device.solve_dtype
    if batch_size is not None and batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}.")
    if screening and squid_device is None:
        raise ValueError("screening=True requires squid_device.")
    if isinstance(pickup_loop, str) and squid_device is None:
        raise ValueError(
            "A named pickup_loop requires squid_device; otherwise pass an explicit "
            "(k, 2) contour in sample length units."
        )
    positions = np.atleast_2d(np.asarray(positions, dtype=float))
    B = positions.shape[0]
    if squid_device is not None:
        contour, z_loop = _pickup_contour(squid_device, pickup_loop, length_units)
    else:
        contour, z_loop = _ccw(np.asarray(pickup_loop, dtype=float)), 0.0
    heights = _resolve_heights(squid_height, B)
    z_pl = heights + z_loop
    sample_J = {
        name: _tensor(sample_solution.film_solutions[name].current_density, dtype, torch_device)
        for name in device.meshes
    }
    field_units = f"{current_units} / {length_units}"
    mu0_flux = _global_ureg(f"1 mu_0 * {current_units} * {length_units}")

    squid_model = None
    if screening:
        if squid_device.length_units != length_units:
            raise ValueError(
                "screening=True requires the SQUID and sample devices to share length units "
                f"(got {squid_device.length_units!r} vs {length_units!r})."
            )
        squid_model = factorize_model(
            device=squid_device, current_units=current_units, torch_device=torch_device
        )

    out = np.zeros(B, dtype=float)
    for start in range(0, B, batch_size or B):
        chunk = positions[start : start + (batch_size or B)]
        Bc = chunk.shape[0]
        h_chunk = heights if heights.ndim == 0 else heights[start : start + Bc]
        z_chunk = z_pl if np.ndim(z_pl) == 0 else z_pl[start : start + Bc]
        pts = contour[None, :, :] + chunk[:, None, :]
        flux = _contour_flux(device, sample_J, pts, z_chunk, torch_device)
        if screening:
            H_squid = _cross_field_maps(
                src_dev=device, src_Js=sample_J, dst_dev=squid_device, dst_z_offset=h_chunk,
                shifts=chunk, dtype=dtype, torch_device=torch_device,
            )
            squid_result = solve_many(
                model=squid_model, applied_field_arrays=H_squid, field_units=field_units,
                current_units=current_units, iterations=iterations, coupling=coupling,
                sharding=sharding, torch_device=torch_device,
            )
            pts_sq = np.broadcast_to(contour[None], (Bc,) + contour.shape)
            flux = flux + _contour_flux(
                squid_device, squid_result.current_densities, pts_sq, z_loop, torch_device
            )
        Phi = (flux * mu0_flux).to(units)
        out[start : start + Bc] = Phi.magnitude
    if with_units:
        return out * _global_ureg(units)
    return out


def build_scan_forward(
    sample_device,
    squid_solution: Solution,
    positions: np.ndarray,
    *,
    squid_height: Union[float, np.ndarray],
    pickup_loop: Union[str, np.ndarray],
    I_fc: Union[str, float],
    iterations: int = 0,
    current_units: str = "mA",
    units: str = "Phi_0 / A",
    dtype=None,
    torch_device="cuda",
):
    """A **differentiable** susceptibility-scan forward model.

    Wraps :func:`superscreen_tpu_torch.build_adjoint_model` with the
    scanning geometry: the probe's applied-field maps (one
    ``biot_savart_batch`` launch, :func:`applied_field_maps`) and the
    pickup-loop readout tensors are parameter-independent and are made
    once, on ``torch_device``.  The returned function maps the adjoint
    parameter dict to the ``(B,)`` susceptibility map in ``units`` through
    one batched forward pass (``B`` right-hand sides against one LU per
    film); ``torch.autograd`` differentiates it with respect to the
    sample's per-site ``Lambda``, circulating currents, vortex amplitudes
    and terminal currents.

    The scan is first-order (frozen probe currents), as
    :func:`susceptibility_scan` with ``back_action=0``: the two agree to
    solver precision for the same inputs.

    Args:
        sample_device: The meshed sample.
        squid_solution: The susceptometer solved standalone with its
            field-coil drive.
        positions: ``(B, 2)`` scan positions (sample length units).
        squid_height: Scalar or ``(B,)`` probe heights.
        pickup_loop: Polygon name in the SQUID device or ``(k, 2)``
            contour (SQUID coordinates).
        I_fc: The field-coil drive used for ``squid_solution`` (string
            with units, or a float in amperes).
        iterations: Inter-film coupling rounds for multi-film samples.
        current_units: Working current units of the adjoint model.
        units: Units of the returned map.
        dtype: Adjoint model dtype (default: the device's solve dtype).
        torch_device: ``"cuda"`` (default) or ``"cpu"``.

    Returns:
        ``(adjoint_model, scan_fn)`` where ``scan_fn(params) -> (B,)``;
        get or edit ``params`` through ``adjoint_model.default_params()``
        (its ``"applied_field"`` entry is ignored: the probe's field is
        part of the scan geometry).
    """
    from ..adjoint import build_adjoint_model

    torch_device = resolve_torch_device(torch_device)
    device = sample_device
    positions = np.atleast_2d(np.asarray(positions, dtype=float))
    heights = _resolve_heights(squid_height, positions.shape[0])
    contour, z_loop = _pickup_contour(squid_solution.device, pickup_loop, device.length_units)
    length_units = device.length_units
    field_units = f"{current_units} / {length_units}"
    model = build_adjoint_model(
        device, field_units=field_units, current_units=current_units, dtype=dtype,
        torch_device=torch_device,
    )
    H_maps = {
        name: H.to(model.dtype)
        for name, H in applied_field_maps(
            device, squid_solution, positions, squid_height=squid_height,
            current_units=current_units, torch_device=torch_device,
        ).items()
    }
    R = {
        name: r.to(model.dtype)
        for name, r in _readout_tensors(
            device, contour[None, :, :] + positions[:, None, :], heights + z_loop, torch_device
        ).items()
    }
    I_amp = (_global_ureg(I_fc) if isinstance(I_fc, str) else I_fc * _global_ureg("A")).to("A")
    factor = float(
        (_global_ureg(f"1 mu_0 * {current_units} * {length_units}") / I_amp).to(units).magnitude
    )
    forward = model.forward_fn(iterations)
    order = model.film_order

    def scan_fn(params):
        out = forward({**params, "applied_field": H_maps})
        return factor * _readout_flux(R, {name: out[name]["current_density"] for name in order})

    return model, scan_fn

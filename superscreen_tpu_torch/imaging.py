"""Current imaging: Fourier inversion of out-of-plane field maps.

Counterpart of ``superscreen_tpu/imaging.py``.  Scanning magnetometry
measures ``B_z(x, y)`` on a plane a height ``z`` above a current-carrying
film; the standard analysis (Roth, Sepulveda & Wikswo, J. Appl. Phys. 65,
361 (1989)) inverts it for the sheet current.  In terms of the stream
function ``g`` (``J = curl(g zhat)``) the forward map is diagonal in
Fourier space,

    Bz_hat(k; z) = (mu_0 |k| / 2) * exp(-|k| z) * g_hat(k),

and the inversion multiplies by ``exp(+|k| z)``, which amplifies noise
exponentially; a window (cosine rolloff ending at ``k_cutoff``)
regularizes it.

The transforms are ``torch.fft`` (cuFFT on the card).  Every function
takes NumPy arrays or tensors and computes on ``torch_device``: by default
the device of a tensor argument, else ``"cuda"`` (which raises without a
card; pass ``"cpu"`` for the CPU).  They return tensors on that device,
except :func:`invert_field_map`, which returns NumPy arrays.

Conventions: uniform grid, ``Bz[i, j]`` at ``(x_j, y_i)`` (row = y), any
self-consistent unit system.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .units import ureg as _ureg

__all__ = [
    "MU_0",
    "bz_to_current_density",
    "bz_to_stream",
    "invert_field_map",
    "stream_to_bz",
    "stream_to_current_density",
]

MU_0 = 4e-7 * np.pi  # H/m


def _as_tensor(values, torch_device) -> torch.Tensor:
    """``values`` as a floating tensor on the compute device: the tensor's
    own device unless ``torch_device`` says otherwise, ``"cuda"`` for a
    NumPy array."""
    from .solver.solve import resolve_torch_device

    if torch_device is None:
        torch_device = values.device if isinstance(values, torch.Tensor) else "cuda"
    dev = resolve_torch_device(torch_device)
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.array(values, dtype=float))
    return values.to(dev)


def _k_grids(ny: int, nx: int, dx: float, dy: float, like: torch.Tensor):
    kx = 2 * np.pi * torch.fft.fftfreq(nx, d=dx, dtype=like.dtype, device=like.device)
    ky = 2 * np.pi * torch.fft.fftfreq(ny, d=dy, dtype=like.dtype, device=like.device)
    KY, KX = torch.meshgrid(ky, kx, indexing="ij")
    return KX, KY, torch.sqrt(KX**2 + KY**2)


def _tukey_lowpass(K: torch.Tensor, k_cutoff: float, rolloff_start: float = 0.7):
    """Unity in the passband, cosine rolloff from ``rolloff_start*k_cutoff``
    to ``k_cutoff``, zero beyond (a Tukey window in k)."""
    k0 = rolloff_start * k_cutoff
    t = (K - k0) / (k_cutoff - k0)
    w = 0.5 * (1 + torch.cos(np.pi * torch.clamp(t, 0.0, 1.0)))
    return torch.where(K < k_cutoff, w, torch.zeros_like(w))


def stream_to_bz(g, dx: float, dy: float, z: float, *, torch_device=None) -> torch.Tensor:
    """Forward map: ``B_z`` (tesla) at height ``z`` (meters) from a gridded
    stream function ``g`` (amperes) sampled with spacings ``dx, dy``
    (meters).  Periodic boundary conditions (pad the grid to taste)."""
    g = _as_tensor(g, torch_device)
    _, _, K = _k_grids(*g.shape, dx=dx, dy=dy, like=g)
    bz_hat = 0.5 * MU_0 * K * torch.exp(-K * z) * torch.fft.fft2(g)
    return torch.fft.ifft2(bz_hat).real


def bz_to_stream(
    bz,
    dx: float,
    dy: float,
    z: float,
    *,
    k_cutoff: Optional[float] = None,
    max_amplification: float = 100.0,
    torch_device=None,
) -> torch.Tensor:
    """Inverse map: the stream function ``g`` (amperes) from a measured
    ``B_z`` map (tesla) at height ``z`` (meters).

    Args:
        bz: ``(ny, nx)`` field map, tesla.
        dx, dy: Grid spacings, meters.
        z: Measurement height above the film plane, meters.
        k_cutoff: Low-pass cutoff wavenumber (rad/m).  Defaults to the
            smaller of the grid Nyquist limit and the wavenumber at which
            the deconvolution gain ``exp(k z)`` reaches
            ``max_amplification``.
        max_amplification: Cap on the ``exp(k z)`` gain used for the
            default cutoff.
        torch_device: Where to compute (see the module docstring).

    Returns:
        ``(ny, nx)`` stream function, amperes, with zero mean (``g`` is
        only defined up to a constant).
    """
    bz = _as_tensor(bz, torch_device)
    ny, nx = bz.shape
    _, _, K = _k_grids(ny, nx, dx=dx, dy=dy, like=bz)
    nyquist = np.pi * min(1.0 / dx, 1.0 / dy)
    if k_cutoff is None:
        k_noise = np.log(max_amplification) / max(z, 1e-30)
        k_cutoff = min(nyquist, k_noise)
    window = _tukey_lowpass(K, k_cutoff)
    positive = K > 0
    safe_K = torch.where(positive, K, torch.ones_like(K))
    gain = torch.where(positive, 2.0 * torch.exp(K * z) / (MU_0 * safe_K), torch.zeros_like(K))
    return torch.fft.ifft2(torch.fft.fft2(bz) * gain * window).real


def stream_to_current_density(
    g, dx: float, dy: float, *, torch_device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Jx, Jy)`` (A/m) from a gridded stream function (amperes) via
    spectral differentiation: ``Jx = dg/dy``, ``Jy = -dg/dx``."""
    g = _as_tensor(g, torch_device)
    KX, KY, _ = _k_grids(*g.shape, dx=dx, dy=dy, like=g)
    g_hat = torch.fft.fft2(g)
    jx = torch.fft.ifft2(1j * KY * g_hat).real
    jy = torch.fft.ifft2(-1j * KX * g_hat).real
    return jx, jy


def bz_to_current_density(
    bz,
    dx: float,
    dy: float,
    z: float,
    *,
    k_cutoff: Optional[float] = None,
    max_amplification: float = 100.0,
    torch_device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-call current imaging: ``(g, Jx, Jy)`` from a ``B_z`` map.

    SI in, SI out (tesla, meters -> amperes, A/m); see
    :func:`invert_field_map` for the unit-aware version.
    """
    g = bz_to_stream(
        bz, dx, dy, z, k_cutoff=k_cutoff, max_amplification=max_amplification,
        torch_device=torch_device,
    )
    jx, jy = stream_to_current_density(g, dx, dy)
    return g, jx, jy


def invert_field_map(
    bz,
    dx: float,
    dy: float,
    z: float,
    *,
    field_units: str = "mT",
    length_units: str = "um",
    current_units: str = "uA",
    k_cutoff: Optional[float] = None,
    max_amplification: float = 100.0,
    torch_device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unit-aware current imaging.

    Args:
        bz: ``(ny, nx)`` out-of-plane field map in ``field_units`` (B- or
            H-type; H is converted via mu_0).
        dx, dy, z: Grid spacings and measurement height in
            ``length_units``.
        field_units, length_units, current_units: Units of the inputs and
            outputs.
        k_cutoff: Optional cutoff in rad/``length_units``.
        max_amplification: See :func:`bz_to_stream`.
        torch_device: Where to compute (see the module docstring).

    Returns:
        ``(g, Jx, Jy)`` NumPy arrays: stream function in ``current_units``
        and sheet current in ``current_units / length_units``.
    """
    from .solver.utils import convert_field

    bz = _as_tensor(bz, torch_device)
    to_tesla = float(
        convert_field(1.0, "tesla", old_units=field_units, ureg=_ureg, with_units=False)
    )
    lf = float(_ureg(f"1 {length_units}").to("m").magnitude)
    kc = None if k_cutoff is None else k_cutoff / lf
    g, jx, jy = bz_to_current_density(
        bz * to_tesla, dx * lf, dy * lf, z * lf, k_cutoff=kc, max_amplification=max_amplification
    )
    cf = float(_ureg("1 A").to(current_units).magnitude)
    jf = float(_ureg("1 A/m").to(f"{current_units}/{length_units}").magnitude)
    return (g * cf).cpu().numpy(), (jx * jf).cpu().numpy(), (jy * jf).cpu().numpy()

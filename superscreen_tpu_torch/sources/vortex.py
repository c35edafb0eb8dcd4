"""Monopole (vortex) and Pearl-vortex field sources.

Counterpart of ``superscreen_tpu/sources/vortex.py`` (host NumPy); the
Pearl field is evaluated on an unshifted FFT frequency grid.
"""

from typing import Tuple, Union

import numpy as np

from ..parameter import Parameter

__all__ = [
    "monopole",
    "MonopoleField",
    "VortexField",
    "pearl_vortex",
    "PearlVortexField",
]

_TWO_PI = 2 * np.pi


def monopole(
    x: Union[float, np.ndarray],
    y: Union[float, np.ndarray],
    z: Union[float, np.ndarray],
    *,
    r0: Tuple[float, float, float] = (0, 0, 0),
    nPhi0: Union[int, float] = 1,
    vector: bool = False,
) -> Union[float, np.ndarray]:
    """Field of a flux monopole, ``mu_0 H = nPhi0/(2 pi) r / |r|^3``, in
    units of ``Phi_0 / length_units**2``.

    Args:
        x, y, z: Evaluation coordinates.
        r0: Monopole position.
        nPhi0: Number of flux quanta in the monopole.
        vector: Return the vector field instead of the z-component.
    """
    dx, dy, dz = (c - c0 for c, c0 in zip((x, y, z), r0))
    inv_r3 = (dx * dx + dy * dy + dz * dz) ** -1.5
    scale = nPhi0 / _TWO_PI
    if not vector:
        return scale * dz * inv_r3
    return scale * np.stack([dx * inv_r3, dy * inv_r3, dz * inv_r3], axis=1)


def MonopoleField(
    r0: Tuple[float, float, float] = (0, 0, 0),
    nPhi0: Union[int, float] = 1,
    vector: bool = False,
) -> Parameter:
    """A Parameter computing the (z-component of the) field from a flux
    monopole at ``r0`` containing ``nPhi0`` flux quanta, in units of
    ``Phi_0 / length_units**2``."""
    return Parameter(monopole, r0=r0, nPhi0=nPhi0, vector=vector)


VortexField = MonopoleField


def pearl_vortex(
    x: Union[float, np.ndarray],
    y: Union[float, np.ndarray],
    z: Union[float, np.ndarray],
    *,
    xs: np.ndarray,
    ys: np.ndarray,
    Lambda: float = 0,
    r0: Tuple[float, float, float] = (0, 0, 0),
    nPhi0: Union[int, float] = 1,
) -> Union[float, np.ndarray]:
    """The z-component of the field from a Pearl vortex via Fourier
    transform: ``F{mu_0 Hz}(k) = nPhi0 exp(-k z) / (1 + 2 Lambda k)``,
    in units of ``Phi_0 / length_units**2``.

    The spectrum is sampled on the FFT grid implied by ``(xs, ys)``,
    inverse-transformed, and linearly interpolated to the query points.

    Args:
        x, y, z: Evaluation coordinates (all ``z`` must be equal).
        xs, ys: Coordinate vectors defining the FFT domain (must contain all
            evaluation points).
        Lambda: Effective penetration depth (half the Pearl length).
        r0: Vortex position.
        nPhi0: Number of flux quanta in the vortex.
    """
    from scipy.interpolate import LinearNDInterpolator

    x, y, z = np.atleast_1d(x, y, z)
    if not np.allclose(z, z[0]):
        raise ValueError("All elements of the vector z must be equal.")
    # Work in vortex-centered coordinates.
    x = x - r0[0]
    y = y - r0[1]
    height = abs(z[0] - r0[2])
    xs, ys = np.sort(xs), np.sort(ys)
    out_of_domain = (
        (x.min() < xs[0])
        or (x.max() > xs[-1])
        or (y.min() < ys[0])
        or (y.max() > ys[-1])
    )
    if out_of_domain:
        raise ValueError(
            "The rectangle defined by xs and ys must contain the convex hull "
            "of the region defined by (x - x0) and (y - y0)."
        )
    step_x = xs[1] - xs[0]
    step_y = ys[1] - ys[0]
    # Unshifted FFT frequency grid (sparse meshgrid broadcasts to 2-D).
    kx = _TWO_PI * np.fft.fftfreq(len(xs), d=step_x)
    ky = _TWO_PI * np.fft.fftfreq(len(ys), d=step_y)
    k = np.hypot(kx[None, :], ky[:, None])
    spectrum = nPhi0 * np.exp(-k * height) / (1.0 + 2.0 * Lambda * k)
    # ifft2 puts the vortex at the grid corner; roll it to the center so the
    # field lines up with the (xs, ys) sample points.
    field = np.abs(np.fft.fftshift(np.fft.ifft2(spectrum))) / (step_x * step_y)
    grid_xy = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    interp = LinearNDInterpolator(grid_xy, field.ravel())
    return interp(np.column_stack([x, y])).squeeze()


def PearlVortexField(
    *,
    r0: Tuple[float, float, float] = (0, 0, 0),
    Lambda: float = 0,
    nPhi0: Union[int, float] = 1,
    xs: np.ndarray,
    ys: np.ndarray,
) -> Parameter:
    """A Parameter computing the z-component of the field from a Pearl
    vortex (see :func:`pearl_vortex`)."""
    return Parameter(
        pearl_vortex, xs=xs, ys=ys, Lambda=Lambda, r0=r0, nPhi0=nPhi0
    )

"""Dipole field sources.

Counterpart of ``superscreen_tpu/sources/dipole.py`` (host NumPy): the
dipole-distribution sum is one broadcasted ``(n_eval, m, 3)`` evaluation
over all (evaluation point, dipole) pairs.
"""

from typing import Optional, Tuple, Union

import numpy as np

from ..parameter import Parameter
from ..units import ureg

__all__ = ["dipole_field", "dipole_distribution", "DipoleField"]

_MU0_OVER_4PI = 1.25663706212e-06 / (4 * np.pi)


def _dipole_sum(separation: np.ndarray, moments: np.ndarray) -> np.ndarray:
    """Dipole B-field (tesla) for per-dipole separation vectors.

    ``separation`` holds vectors from each dipole to the evaluation point
    (any leading shape, trailing axis 3, SI meters); ``moments`` broadcasts
    against it (SI A m^2).  Implements ``mu0/4pi * (3 r (m.r) - m r^2)/r^5``.
    """
    r2 = np.sum(separation * separation, axis=-1, keepdims=True)
    r = np.sqrt(r2)
    m_dot_r = np.sum(moments * separation, axis=-1, keepdims=True)
    return _MU0_OVER_4PI * (3.0 * separation * m_dot_r - moments * r2) / (r2 * r2 * r)


def dipole_field(
    eval_coords: np.ndarray,
    r0: Union[np.ndarray, Tuple[float, float, float]] = (0, 0, 0),
    moment: Union[np.ndarray, Tuple[float, float, float]] = (0, 0, 0),
) -> np.ndarray:
    """3D field (tesla) of a single dipole with ``moment`` [A m^2] at ``r0``
    [m], evaluated at ``eval_coords`` [m]."""
    moment, r0 = np.atleast_1d(moment, r0)
    separation = np.atleast_2d(eval_coords).reshape((-1, 3)) - r0
    return _dipole_sum(separation, moment).squeeze()


def dipole_distribution(
    x: Union[float, np.ndarray],
    y: Union[float, np.ndarray],
    z: Union[float, np.ndarray],
    *,
    dipole_positions: np.ndarray,
    dipole_moments: Union[np.ndarray, Tuple[float, float, float]],
    component: Optional[str] = None,
    length_units: str = "um",
    moment_units: str = "mu_B",
) -> np.ndarray:
    """Field (tesla) from a distribution of dipoles, evaluated at
    ``(x, y, z)``.

    Args:
        x, y, z: Evaluation coordinates in ``length_units``.
        dipole_positions: ``(m, 3)`` dipole positions in ``length_units``.
        dipole_moments: ``(m, 3)`` or single ``(3,)`` moment in
            ``moment_units``.
        component: "x", "y", "z", or None for the full vector field.
        length_units: Units of all coordinates.
        moment_units: Units of the moments (e.g. "mu_B").
    """
    pick = Ellipsis if component is None else "xyz".index(component)
    meters = ureg(length_units).to("m").magnitude
    x, y, z = np.atleast_1d(x, y, z)
    if z.shape[0] == 1:
        z = np.broadcast_to(z, x.shape)
    eval_coords = np.column_stack([x, y, z]) * meters
    positions, moments = np.atleast_2d(dipole_positions, dipole_moments)
    positions = positions * meters
    moments = moments * ureg(moment_units).to("A * m ** 2").magnitude
    if moments.shape[0] == 1:
        moments = np.broadcast_to(moments, positions.shape)
    elif moments.shape[0] != positions.shape[0]:
        raise ValueError(
            f"The number of dipole moments ({moments.shape[0]}) must be "
            f"either 1 or equal to the number of dipole positions "
            f"({positions.shape[0]})."
        )
    # One broadcasted evaluation over all (eval point, dipole) pairs.
    separation = eval_coords[:, np.newaxis, :] - positions[np.newaxis]
    B = _dipole_sum(separation, moments[np.newaxis]).sum(axis=1)
    return np.atleast_2d(B.squeeze())[:, pick]


def DipoleField(
    *,
    dipole_positions: Union[np.ndarray, Tuple[float, float, float]],
    dipole_moments: Union[np.ndarray, Tuple[float, float, float]],
    component: Optional[str] = None,
    length_units: str = "um",
    moment_units: str = "mu_B",
) -> Parameter:
    """A Parameter computing the field (tesla) from a distribution of
    dipoles.

    Args:
        dipole_positions: ``(m, 3)`` or ``(3,)`` dipole positions.
        dipole_moments: ``(m, 3)`` or ``(3,)`` dipole moments.
        component: "x", "y", "z", or None for the vector field.
        length_units: Units of positions.
        moment_units: Units of moments.
    """
    if component not in (None, "x", "y", "z"):
        raise ValueError(
            f"Component must be 'x', 'y', 'z', or None (got {component!r})."
        )
    return Parameter(
        dipole_distribution,
        dipole_positions=dipole_positions,
        dipole_moments=dipole_moments,
        component=component,
        length_units=length_units,
        moment_units=moment_units,
    )

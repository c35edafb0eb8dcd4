"""Sheet-current Biot-Savart field source.

Counterpart of ``superscreen_tpu/sources/current.py``: the
``O(n_eval * n_mesh)`` sum runs on the torch device through
:func:`superscreen_tpu_torch.ops.kernels.biot_savart_2d_field`, in the
caller's length and current units; one scalar turns the result into tesla.
"""

from typing import Optional, Union

import numpy as np
import torch

from ..ops.kernels import biot_savart_2d_field
from ..parameter import Parameter
from ..units import ureg

__all__ = ["biot_savart_2d", "SheetCurrentField"]

_MU_0 = 1.25663706212e-06  # T m / A


def _si_factor(units: str, target: str) -> float:
    """Conversion factor from ``units`` to the SI ``target`` unit."""
    return ureg(units).to(target).magnitude


def biot_savart_2d(
    x: Union[float, np.ndarray],
    y: Union[float, np.ndarray],
    z: Union[float, np.ndarray],
    *,
    positions: np.ndarray,
    current_densities: np.ndarray,
    z0: float = 0,
    areas: Optional[np.ndarray] = None,
    length_units: str = "um",
    current_units: str = "uA",
    vector: bool = True,
    torch_device="cuda",
) -> np.ndarray:
    """Magnetic field (tesla) at ``(x, y, z)`` from a 2D sheet of current at
    height ``z0``.

    The sum runs in float32 when ``current_densities`` is float32 and in
    float64 otherwise.  The z-component at points of one height above or
    below the sheet goes through the ``biot_savart_batch`` kernel on the
    card; see :func:`superscreen_tpu_torch.ops.kernels.biot_savart_2d_field`.

    Args:
        x, y, z: Evaluation coordinates (``length_units``), scalars or
            shape ``(n,)`` vectors.
        positions: ``(m, 2)`` sheet coordinates in ``length_units``.
        current_densities: ``(m, 2)`` sheet current density in
            ``current_units / length_units``.
        z0: Vertical position of the current sheet.
        areas: ``(m,)`` vertex areas in ``length_units**2``; computed by
            Delaunay triangulation if omitted.
        length_units: Units of all coordinates.
        current_units: Units of currents.
        vector: Return the full vector field ``(n, 3)`` instead of just the
            z-component ``(n,)``.
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``.
    """
    from ..solver.solve import highest_matmul_precision, resolve_torch_device

    torch_device = resolve_torch_device(torch_device)
    x, y, z = np.atleast_1d(x, y, z)
    z = np.broadcast_to(z, x.shape) if z.size == 1 else z
    targets = np.column_stack([x, y, z])
    sheet_xy, densities = np.atleast_2d(positions, current_densities)
    if areas is None:
        from scipy.spatial import Delaunay

        from ..ops.fem import vertex_areas

        # Triangulated in metres, as the JAX package does, so that both
        # break ties between cocircular points the same way.
        meters = _si_factor(length_units, "m")
        areas = vertex_areas(sheet_xy, Delaunay(sheet_xy * meters).simplices)
    sheet_xyz = np.column_stack([sheet_xy, np.full(len(sheet_xy), z0)])
    dtype = torch.float32 if densities.dtype == np.float32 else torch.float64

    def on_device(array):
        return torch.as_tensor(np.asarray(array), dtype=dtype, device=torch_device)

    with highest_matmul_precision():
        field = biot_savart_2d_field(
            on_device(targets),
            on_device(sheet_xyz),
            on_device(densities),
            on_device(areas),
            vector=vector,
        )
    tesla = _MU_0 * _si_factor(f"{current_units} / {length_units}", "A / m")
    return field.cpu().numpy() * tesla


def SheetCurrentField(
    *,
    sheet_positions: np.ndarray,
    current_densities: np.ndarray,
    z0: float,
    length_units: str = "um",
    current_units: str = "uA",
    torch_device="cuda",
) -> Parameter:
    """A Parameter computing the z-component of the field (in tesla) from a
    2D sheet of current, so one solution can drive another model.

    Args:
        sheet_positions: ``(m, 2)`` sheet coordinates.
        current_densities: ``(m, 2)`` sheet current density.
        z0: Vertical position of the sheet.
        length_units: Units of all coordinates.
        current_units: Units of currents.
        torch_device: Where the sum runs: ``"cuda"`` (default; raises
            without a card) or ``"cpu"``.
    """
    return Parameter(
        biot_savart_2d,
        positions=sheet_positions,
        current_densities=current_densities,
        z0=z0,
        length_units=length_units,
        current_units=current_units,
        vector=False,
        torch_device=torch_device,
    )

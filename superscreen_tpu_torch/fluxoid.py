"""Fluxoid tools: hole-enclosing polygons and fluxoid-state optimization.

Counterpart of ``superscreen_tpu/fluxoid.py``, on this package's polygon
operations (``polygon_ops``) and its ``solve`` and ``solve_many``.
"""

import logging
from contextlib import contextmanager
from typing import Dict, List, Optional, Union

import numpy as np

from . import polygon_ops as pops
from .device import Device
from .solution import Solution
from .solver import FactorizedModel, factorize_model, solve

logger = logging.getLogger(__name__)

__all__ = ["make_fluxoid_polygons", "find_fluxoid_solution"]


def _hole_clearance(device: Device, hole_name: str) -> float:
    """Distance from a hole's boundary to the nearest other polygon boundary
    in the same layer (films and holes alike)."""
    hole = device.holes[hole_name]
    distances = [
        pops.polygon_boundary_distance(hole.points, neighbor.points)
        for neighbor in list(device.films.values()) + list(device.holes.values())
        if neighbor.layer == hole.layer and neighbor.name != hole_name
    ]
    return min(distances)


def make_fluxoid_polygons(
    device: Device,
    holes: Optional[Union[List[str], str]] = None,
    join_style: str = "mitre",
    interp_points: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Build a polygon around each requested hole, suitable for evaluating
    that hole's fluxoid.

    Each hole boundary is offset outward by half its clearance to the nearest
    neighboring polygon in the same layer, so the resulting contour stays in
    superconductor and encloses only its own hole.

    Args:
        device: The device whose holes to enclose.
        holes: Hole name or list of names; all holes by default.
        join_style: Corner treatment for the outward offset.
        interp_points: If given, resample each polygon to this many vertices.

    Returns:
        ``{hole_name: (m, 2) polygon coordinate array}``.
    """
    if holes is None:
        requested = list(device.holes)
    elif isinstance(holes, str):
        requested = [holes]
    else:
        requested = list(holes)

    enclosing = {}
    for name in requested:
        offset = 0.5 * _hole_clearance(device, name)
        contour = pops.buffer_polygon(
            device.holes[name].points, offset, join_style=join_style
        )
        if interp_points:
            contour = pops.resample_polygon(contour, interp_points)
        enclosing[name] = contour
    return enclosing


@contextmanager
def _circulating_currents(model: FactorizedModel, currents: Dict[str, float]):
    """Temporarily install ``currents`` on ``model``, restoring on exit."""
    saved = model.circulating_currents
    model.set_circulating_currents(currents)
    try:
        yield model
    finally:
        model.set_circulating_currents(saved)


def find_fluxoid_solution(
    model: Union[FactorizedModel, Device],
    fluxoids: Optional[Dict[str, float]] = None,
    **solve_kwargs,
) -> Solution:
    """Find the circulating currents that put each hole in a prescribed
    fluxoid state, and return the solution with those currents installed.

    The fluxoid is affine in the circulating currents, so one zero-current
    solve plus the device's mutual-inductance matrix ``M`` determine the
    answer: ``I = M^{-1} (Phi_target - Phi_zero_current)``.

    Args:
        model: Factorized model to optimize (its circulating currents are
            restored before returning).  A meshed :class:`Device` is also
            accepted and factorized on the fly.
        fluxoids: Target fluxoid per hole in units of ``Phi_0``; holes not
            listed are targeted at 0.
        solve_kwargs: Forwarded to :func:`superscreen_tpu_torch.solve` (e.g.
            ``applied_field``, ``iterations``) and, but for
            ``applied_field``, to :meth:`Device.mutual_inductance_matrix`.
            ``torch_device`` (default ``"cuda"``, which raises without a
            card) goes to both; a given model must live on it.

    Returns:
        The optimized :class:`Solution`.
    """
    if isinstance(model, Device):
        model = factorize_model(
            device=model,
            current_units=solve_kwargs.pop("current_units", "uA"),
            torch_device=solve_kwargs.get("torch_device", "cuda"),
        )
    targets = dict(fluxoids or {})
    hole_names = list(model.device.holes)
    applied_field = solve_kwargs.pop("applied_field", None)

    def last_solution() -> Solution:
        return solve(model=model, applied_field=applied_field, **solve_kwargs)[-1]

    if not hole_names:
        if any(targets.values()):
            raise ValueError(
                "Cannot realize a nonzero fluxoid in a device with no holes."
            )
        with _circulating_currents(model, {}):
            return last_solution()

    with _circulating_currents(model, dict.fromkeys(hole_names, 0)):
        zero_current_solution = last_solution()
    phi_zero = np.array(
        [
            sum(zero_current_solution.hole_fluxoid(name)).to("Phi_0").magnitude
            for name in hole_names
        ]
    )
    phi_target = np.array([targets.get(name, 0) for name in hole_names])

    mutuals = model.device.mutual_inductance_matrix(
        units=f"Phi_0 / {model.current_units}", **solve_kwargs
    )
    optimal = np.linalg.solve(np.asarray(mutuals.magnitude), phi_target - phi_zero)
    with _circulating_currents(model, dict(zip(hole_names, optimal))):
        return last_solution()

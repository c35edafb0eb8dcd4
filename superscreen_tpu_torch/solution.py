"""Solution containers.

Counterparts of ``Vortex``, ``FilmSolution`` and ``Solution`` in
``superscreen_tpu/solution.py``, holding the fields :func:`solve` and
:func:`solve_many` fill: per-film stream functions, current densities and
fields as NumPy arrays, and the drive they were solved for.
Post-processing is not provided yet.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np

__all__ = ["Vortex", "FilmSolution", "Solution"]


@dataclass
class Vortex:
    """A vortex at ``(x, y)`` in ``film`` carrying ``nPhi0`` flux quanta.

    Args:
        x: Vortex x-position.
        y: Vortex y-position.
        film: Name of the film in which the vortex is pinned.
        nPhi0: Number of flux quanta in the vortex.
    """

    x: float
    y: float
    film: str
    nPhi0: float = 1


@dataclass(eq=False)
class FilmSolution:
    """Raw per-film solver output, in ``field_units`` / ``current_units`` /
    ``device.length_units``.

    Args:
        stream: Stream function at the mesh sites.
        current_density: Sheet current density at the mesh sites.
        applied_field: Applied field at the mesh sites.
        self_field: Field from this film's own screening currents.
        field_from_other_films: Screening field from all other films, if any.
    """

    stream: np.ndarray
    current_density: np.ndarray
    applied_field: np.ndarray
    self_field: np.ndarray
    field_from_other_films: Optional[np.ndarray] = None

    @property
    def total_field(self) -> np.ndarray:
        """Total out-of-plane field in the film."""
        total = self.applied_field + self.self_field
        if self.field_from_other_films is not None:
            total = total + self.field_from_other_films
        return total


class Solution:
    """Stream functions and fields for a solved device.

    Args:
        device: The solved device.
        film_solutions: ``{film_name: FilmSolution}``.
        applied_field_func: The applied-field callable.
        field_units: Units of the applied/computed fields.
        current_units: Units of currents.
        circulating_currents: ``{hole_name: circulating_current}``.
        terminal_currents: ``{film_name: {terminal_name: current}}``.
        vortices: The vortices in the device.
        solver: The entry point that produced the solution.
    """

    def __init__(
        self,
        *,
        device,
        film_solutions: Dict[str, FilmSolution],
        applied_field_func: Callable,
        field_units: str,
        current_units: str,
        circulating_currents: Optional[Dict[str, float]] = None,
        terminal_currents: Optional[Dict[str, Dict[str, float]]] = None,
        vortices: Optional[Sequence[Vortex]] = None,
        solver: str = "superscreen_tpu_torch.solve",
    ):
        self.device = device
        self.film_solutions = film_solutions
        self.applied_field_func = applied_field_func
        self.field_units = field_units
        self.current_units = current_units
        self.circulating_currents = dict(circulating_currents or {})
        self.terminal_currents = dict(terminal_currents or {})
        self.vortices = list(vortices or [])
        self.solver = solver

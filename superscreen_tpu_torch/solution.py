"""Solution containers.

Counterparts of ``FilmSolution`` and ``Solution`` in
``superscreen_tpu/solution.py``, holding the fields :func:`solve` fills:
per-film stream functions, current densities and fields as NumPy arrays.
Post-processing is not provided yet.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["FilmSolution", "Solution"]


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
    ):
        self.device = device
        self.film_solutions = film_solutions
        self.applied_field_func = applied_field_func
        self.field_units = field_units
        self.current_units = current_units
        self.circulating_currents = dict(circulating_currents or {})

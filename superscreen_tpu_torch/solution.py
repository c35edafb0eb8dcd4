"""Solution containers and post-processing.

Counterpart of ``superscreen_tpu/solution.py`` without file I/O and
plotting.  ``FilmSolution`` holds the raw per-film arrays produced by the
solver (NumPy); ``Solution`` layers post-processing on top: interpolation
(:mod:`superscreen_tpu_torch.ops.interp`), flux and fluxoid integrals, and
the field and vector potential anywhere in space.  The interpolation and
the pairwise sums run on the solution's ``torch_device`` (the card unless
the solution was made for the CPU); geometry, units and the quadratures
stay NumPy on the host.
"""

import datetime as dt
import logging
import numbers
import platform
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Literal, NamedTuple, Optional, Sequence, Union

import numpy as np
import scipy
import torch

from .device import Device, Polygon
from .geometry import path_vectors
from .ops import interp as interp_ops
from .ops.fem import in_polygon
from .units import Quantity

logger = logging.getLogger("solution")

__all__ = ["Fluxoid", "Vortex", "FilmSolution", "Solution"]

InterpolatorType = Literal["linear", "cubic"]

# NumPy 2.0 renamed ``trapz`` to ``trapezoid``.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Fluxoid(NamedTuple):
    """The fluxoid of a closed region S:

    flux part: ``int_S mu_0 H_z dA``;
    supercurrent part: ``oint_{dS} mu_0 Lambda J . dl``.
    """

    flux_part: Union[float, Quantity]
    supercurrent_part: Union[float, Quantity]


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
    _total_field: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def total_field(self) -> np.ndarray:
        """Total out-of-plane field in the film."""
        if self._total_field is None:
            total = self.applied_field + self.self_field
            if self.field_from_other_films is not None:
                total = total + self.field_from_other_films
            self._total_field = total
        return self._total_field

    def is_close(
        self, other: "FilmSolution", rtol: float = 1e-4, atol: float = 1e-7
    ) -> bool:
        """Whether two FilmSolutions agree within tolerances."""

        def close(a, b):
            return np.allclose(a, b, rtol=rtol, atol=atol)

        return (
            close(self.stream, other.stream)
            and close(self.applied_field, other.applied_field)
            and close(self.self_field, other.self_field)
            and close(self.total_field, other.total_field)
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, FilmSolution):
            return NotImplemented
        if (self.field_from_other_films is None) != (
            other.field_from_other_films is None
        ):
            return False
        return self is other or self.is_close(other)


def _normalize_coordinates(positions, zs, dtype):
    """Split ``(m, 2)/(m, 3)`` positions and scalar/array zs into
    ``((m, 2) xy, (m,) z)``."""
    xy = np.atleast_2d(positions)
    if xy.shape[1] == 3:
        if zs is not None:
            raise ValueError("zs cannot be given when positions are (m, 3).")
        return xy[:, :2], xy[:, 2]
    if zs is None:
        raise ValueError("zs must be provided when positions are (m, 2).")
    z = np.squeeze(np.asarray(zs))
    if z.ndim == 0:
        z = np.full(xy.shape[0], z.item(), dtype=dtype)
    if not isinstance(z, np.ndarray):
        raise ValueError(f"Expected zs to be an ndarray, but got {type(z)}.")
    return xy, z


def _version_dict() -> Dict[str, str]:
    """Versions of the interpreter and of what this package imports."""
    return {
        "python": platform.python_version(),
        "numpy": np.__version__,
        "scipy": scipy.__version__,
        "torch": torch.__version__,
    }


class Solution:
    """Stream functions and fields for a solved :class:`Device`, plus
    post-processing.

    Args:
        device: The solved device.
        film_solutions: ``{film_name: FilmSolution}`` raw results in
            ``field_units``, ``current_units``, and ``device.length_units``.
        applied_field_func: The applied-field callable.
        field_units: Units of the applied/computed fields.
        current_units: Units of currents.
        circulating_currents: ``{hole_name: circulating_current}``.
        terminal_currents: ``{film_name: {terminal_name: current}}``.
        vortices: Vortices in the device.
        solver: The solver name that generated this solution.
        torch_device: Where post-processing runs its interpolation and
            pairwise sums: ``"cuda"`` (default; the first such call raises
            without a card) or ``"cpu"``.  :func:`solve` and
            :meth:`SweepResult.solution` pass the device the model was
            solved on.
    """

    # Datasets accepted by interp_field, mapped to FilmSolution attributes.
    _FIELD_DATASETS = {
        "field": "total_field",
        "self_field": "self_field",
        "applied_field": "applied_field",
        "field_from_other_films": "field_from_other_films",
    }

    def __init__(
        self,
        *,
        device: Device,
        film_solutions: Dict[str, FilmSolution],
        applied_field_func: Callable,
        field_units: str,
        current_units: str,
        circulating_currents: Optional[Dict[str, float]] = None,
        terminal_currents: Optional[Dict[str, Dict[str, float]]] = None,
        vortices: Optional[Sequence[Vortex]] = None,
        solver: str = "superscreen_tpu_torch.solve",
        torch_device="cuda",
    ):
        # The copy shares the meshes, and with them the cached triangle
        # indices: every solution of a sweep interpolates on one index.
        self.device = device.copy(with_mesh=True, copy_mesh=False)
        self.film_solutions = film_solutions
        self.applied_field_func = applied_field_func
        self.circulating_currents = dict(circulating_currents or {})
        self.terminal_currents = dict(terminal_currents or {})
        self.vortices = list(vortices or [])
        self.torch_device = torch_device
        self._field_units = field_units
        self._current_units = current_units
        self._solver = solver
        self._time_created = dt.datetime.now()
        self._version_info = _version_dict()

    @property
    def field_units(self) -> str:
        """Units of magnetic fields."""
        return self._field_units

    @property
    def current_units(self) -> str:
        """Units of currents."""
        return self._current_units

    @property
    def solver(self) -> str:
        """The solver that generated this solution."""
        return self._solver

    @property
    def time_created(self) -> dt.datetime:
        """Creation timestamp."""
        return self._time_created

    @property
    def version_info(self) -> Dict[str, str]:
        """Dependency versions at creation time."""
        return self._version_info

    def _resolved_torch_device(self) -> torch.device:
        from .solver.solve import resolve_torch_device

        return resolve_torch_device(self.torch_device)

    # -- interpolation on the torch device -----------------------------------

    def _interpolate(
        self,
        film: str,
        values: np.ndarray,
        positions: np.ndarray,
        method: InterpolatorType,
    ) -> np.ndarray:
        """Interpolate per-vertex data at ``positions`` using the film
        mesh's spatial index on the solution's torch device (NaN outside
        the mesh)."""
        mesh = self.device.meshes[film]
        index = mesh.spatial_index(self._resolved_torch_device())
        if method == "linear":
            out = interp_ops.interp_linear(index, values, positions)
        elif method == "cubic":
            values = np.asarray(values)
            if values.ndim == 1:
                out = interp_ops.interp_cubic(
                    index, values, mesh.vertex_gradient(values), positions
                )
            else:
                out = torch.stack(
                    [
                        interp_ops.interp_cubic(
                            index, col, mesh.vertex_gradient(col), positions
                        )
                        for col in values.T
                    ],
                    dim=-1,
                )
        else:
            raise ValueError(
                f"Invalid interpolation method: {method!r} "
                "(expected 'linear' or 'cubic')."
            )
        return out.cpu().numpy()

    def interp_current_density(
        self,
        positions: np.ndarray,
        *,
        film: str,
        method: InterpolatorType = "linear",
        units: Optional[str] = None,
        with_units: bool = False,
    ) -> np.ndarray:
        """Interpolates the sheet current density within a film.

        Args:
            positions: ``(m, 2)`` coordinates at which to evaluate ``J``.
            film: The film in which to interpolate.
            method: "linear" or "cubic".
            units: Desired units (default ``current_units / length_units``).
            with_units: Return a Quantity array.
        """
        positions = np.atleast_2d(positions)
        J = self._interpolate(
            film, self.film_solutions[film].current_density, positions, method
        )
        # Zero J outside the film (including in holes) and wherever the
        # interpolation had no containing triangle.
        keep = self.device.films[film].contains_points(positions)
        keep &= np.isfinite(J).all(axis=1)
        J = np.where(keep[:, None], np.nan_to_num(J), 0.0)
        natural_units = f"{self.current_units} / {self.device.length_units}"
        quantity = Quantity(J, natural_units).to(units or natural_units)
        return quantity if with_units else quantity.magnitude

    def current_through_path(
        self,
        path_coords: np.ndarray,
        *,
        film: str,
        interp_method: str = "linear",
        units: Union[str, None] = None,
        with_units: bool = True,
    ) -> Union[float, Quantity]:
        """Total current crossing a path (line integral of ``J . n``).

        Args:
            path_coords: ``(n, 2)`` path coordinates.
            film: The film in which to evaluate ``J``.
            interp_method: "linear" or "cubic".
            units: Desired current units.
            with_units: Return a Quantity.
        """
        path = np.asarray(path_coords, dtype=float)
        # Midpoint rule: sample J.n at each edge center and sum J.n * dl, so
        # the end edges carry their full weight and a two-point path works.
        midpoints = 0.5 * (path[:-1] + path[1:])
        J_mid = self.interp_current_density(
            midpoints, film=film, method=interp_method, with_units=False
        )
        lengths, normals = path_vectors(path)
        crossing = float(np.sum((J_mid * normals).sum(axis=1) * lengths))
        current = Quantity(crossing, self.current_units)
        current = current.to(units or self.current_units)
        return current if with_units else current.magnitude

    def interp_field(
        self,
        positions: np.ndarray,
        *,
        film: str,
        dataset: Literal[
            "field", "self_field", "applied_field", "field_from_other_films"
        ] = "field",
        method: InterpolatorType = "linear",
        units: Optional[str] = None,
        with_units: bool = False,
    ):
        """Interpolates the z-component of a field dataset within a film.

        Args:
            positions: ``(m, 2)`` coordinates.
            film: The film in which to interpolate.
            dataset: One of "field", "self_field", "applied_field",
                "field_from_other_films".
            method: "linear" or "cubic".
            units: Desired units (default ``field_units``).
            with_units: Return a Quantity array.
        """
        from .solver.utils import convert_field

        try:
            attr = self._FIELD_DATASETS[dataset]
        except KeyError:
            raise ValueError(
                f"Invalid dataset: {dataset!r}. "
                f"Expected one of {tuple(self._FIELD_DATASETS)!r}"
            ) from None
        data = getattr(self.film_solutions[film], attr)
        if data is None:  # field_from_other_films for a single-film device
            data = np.zeros(len(self.device.meshes[film].sites))
        sampled = self._interpolate(film, data, np.atleast_2d(positions), method)
        return convert_field(
            sampled,
            units or self.field_units,
            old_units=self.field_units,
            ureg=self.device.ureg,
            with_units=with_units,
        )

    # -- flux and fluxoid ----------------------------------------------------

    def _film_containing_polygon(self, polygon: Polygon) -> str:
        """Name of the film (in the polygon's layer) containing the polygon."""
        for name, film in self.device.films.items():
            if film.layer == polygon.layer and film.contains_points(
                polygon.points
            ).all():
                return name
        raise ValueError(
            f"No film in layer {polygon.layer!r} contains polygon "
            f"{polygon.name!r}."
        )

    def _integrate_field_over(self, film: str, site_mask) -> Quantity:
        """``sum_i B_z,i * w_i`` over selected mesh sites, as a flux Quantity."""
        from .solver.utils import convert_field

        mesh = self.device.meshes[film]
        B_mT = convert_field(
            self.film_solutions[film].total_field[site_mask],
            "mT",
            old_units=self.field_units,
            ureg=self.device.ureg,
            with_units=False,
        )
        total = float(np.sum(B_mT * mesh.vertex_areas[site_mask]))
        return Quantity(total, f"mT * {self.device.length_units}**2")

    def polygon_flux(
        self,
        name: str,
        units: Optional[str] = None,
        with_units: bool = True,
    ) -> Union[float, Quantity]:
        """Flux of the total field through a named polygon.

        Args:
            name: The polygon name.
            units: Flux units (default ``field_units * length_units**2``).
            with_units: Return a Quantity.
        """
        device = self.device
        candidates = {
            p.name: p for p in device.get_polygons(include_terminals=False)
        }
        if name not in candidates:
            raise ValueError(f"Unknown polygon: {name!r}.")
        polygon = candidates[name]
        film = name if name in device.films else self._film_containing_polygon(polygon)
        inside = polygon.contains_points(device.meshes[film].sites, index=True)
        flux = self._integrate_field_over(film, inside).to(
            units or f"{self.field_units} * {device.length_units}**2"
        )
        return flux if with_units else flux.magnitude

    def polygon_fluxoid(
        self,
        polygon_coords: Union[np.ndarray, Polygon],
        *,
        film: str,
        interp_method: InterpolatorType = "linear",
        units: Optional[str] = "Phi_0",
        with_units: bool = True,
    ) -> Fluxoid:
        """The :class:`Fluxoid` (flux + supercurrent parts) for a polygonal
        region inside a film.

        Args:
            polygon_coords: ``(n, 2)`` polygon vertices (or a Polygon).
            film: The film in which to evaluate fields/currents.
            interp_method: "linear" or "cubic".
            units: Desired flux units (default ``Phi_0``).
            with_units: Return Quantities.
        """
        device = self.device
        if units is None:
            units = f"{self.field_units} * {device.length_units} ** 2"
        if isinstance(polygon_coords, Polygon):
            contour = polygon_coords.points
        else:
            contour = Polygon(points=polygon_coords).points
        if not device.films[film].contains_points(contour).all():
            raise ValueError(
                f"The polygon is not contained within the film ({film!r})."
            )

        inside = Polygon(points=contour).contains_points(device.meshes[film].sites)
        flux_part = self._integrate_field_over(film, inside).to(units)

        supercurrent = self._supercurrent_integral(film, contour, interp_method)
        J_units = f"{self.current_units} / {device.length_units}"
        line_integral = (
            Quantity(supercurrent, J_units) * Quantity(1.0, device.length_units) ** 2
        )
        supercurrent_part = (device.ureg("mu_0") * line_integral).to(units)
        if not with_units:
            return Fluxoid(flux_part.magnitude, supercurrent_part.magnitude)
        return Fluxoid(flux_part, supercurrent_part)

    def _supercurrent_integral(
        self, film: str, contour: np.ndarray, interp_method: InterpolatorType
    ) -> float:
        """``oint Lambda J . dl`` around a closed contour, in solver units.

        The quadrature is the trapezoid rule over the per-vertex products,
        not the midpoint rule of :meth:`current_through_path`: the mutual
        inductances only match the JAX package's with this one.
        """
        J = self.interp_current_density(
            contour, film=film, method=interp_method, with_units=False
        )
        Lambda = self.device.layers[self.device.films[film].layer].Lambda
        if isinstance(Lambda, numbers.Real):
            Lambda_on_contour = np.full(len(contour), float(Lambda))
        else:
            Lambda_on_contour = np.atleast_1d(Lambda(contour[:, 0], contour[:, 1]))
            if Lambda_on_contour.shape[0] != len(contour):
                Lambda_on_contour = np.full(len(contour), Lambda_on_contour.item())
        dl = np.diff(contour, axis=0)
        products = Lambda_on_contour[:-1] * np.sum(J[:-1] * dl, axis=1)
        return float(_trapezoid(products))

    def hole_fluxoid(
        self,
        hole_name: str,
        points: Optional[np.ndarray] = None,
        interp_method: InterpolatorType = "linear",
        units: Optional[str] = "Phi_0",
        with_units: bool = True,
    ) -> Fluxoid:
        """The fluxoid of a polygon enclosing the given hole.

        Args:
            hole_name: The hole name.
            points: Polygon vertices enclosing the hole (auto-generated if
                omitted).
            interp_method: "linear" or "cubic".
            units: Desired flux units.
            with_units: Return Quantities.
        """
        device = self.device
        if points is None:
            from .fluxoid import make_fluxoid_polygons

            points = make_fluxoid_polygons(device, holes=hole_name)[hole_name]
        hole = device.holes[hole_name]
        if not in_polygon(points, hole.points).all():
            raise ValueError(
                f"Hole {hole.name} is not completely enclosed by the given polygon."
            )
        film = next(
            name
            for name, holes in device.holes_by_film().items()
            if any(h.name == hole_name for h in holes)
        )
        return self.polygon_fluxoid(
            points,
            film=film,
            interp_method=interp_method,
            units=units,
            with_units=with_units,
        )

    # -- fields anywhere in space -------------------------------------------

    def screening_field_at_position(
        self,
        positions: np.ndarray,
        *,
        zs: Union[float, np.ndarray, None] = None,
        vector: bool = False,
        interp_method: InterpolatorType = "linear",
        units: Optional[str] = None,
        with_units: bool = True,
        return_sum: bool = True,
    ):
        """Field from device screening currents at any point(s) in space
        (excluding the applied field).

        In-plane points are interpolated on the film mesh; out-of-plane
        points use the Biot-Savart sum over the film's sites on the torch
        device (:func:`superscreen_tpu_torch.sources.biot_savart_2d`).

        Args:
            positions: ``(m, 2)`` or ``(m, 3)`` coordinates.
            zs: z-coordinates (scalar or ``(m,)``) if positions is (m, 2).
            vector: Return the full vector field.
            interp_method: "linear" or "cubic".
            units: Desired units (default ``field_units``).
            with_units: Return Quantities.
            return_sum: Sum over films instead of returning a dict.
        """
        from .solver.utils import convert_field
        from .sources.current import biot_savart_2d

        device = self.device
        dtype = device.solve_dtype
        xy, z = _normalize_coordinates(positions, zs, dtype)
        out_shape = (len(xy), 3) if vector else (len(xy),)
        contributions = {}
        for name, film in device.films.items():
            layer = device.layers[film.layer]
            result = np.zeros(out_shape, dtype=dtype)
            # Per-point: a query AT the film plane and inside the film must
            # use mesh interpolation (the dz=0 Biot-Savart sum is singular
            # there); mixed-z batches get the mask applied pointwise.
            coplanar = (z == layer.z0) & film.contains_points(xy)
            if coplanar.any():
                sampled = self.interp_field(
                    xy[coplanar],
                    film=name,
                    dataset="self_field",
                    method=interp_method,
                    units="tesla",
                    with_units=False,
                )
                if vector:
                    result[coplanar, 2] = sampled
                else:
                    result[coplanar] = sampled
            off_plane = ~coplanar
            if off_plane.any():
                mesh = device.meshes[name]
                result[off_plane] = biot_savart_2d(
                    xy[off_plane, 0],
                    xy[off_plane, 1],
                    z[off_plane],
                    positions=mesh.sites,
                    areas=mesh.vertex_areas,
                    current_densities=self.film_solutions[name].current_density,
                    z0=layer.z0,
                    length_units=device.length_units,
                    current_units=self.current_units,
                    vector=vector,
                    torch_device=self.torch_device,
                )
            contributions[name] = convert_field(
                result,
                units or self.field_units,
                old_units="tesla",
                ureg=device.ureg,
                with_units=with_units,
            )
        return sum(contributions.values()) if return_sum else contributions

    def field_at_position(
        self,
        positions: np.ndarray,
        *,
        zs: Union[float, np.ndarray, None] = None,
        interp_method: InterpolatorType = "linear",
        units: Optional[str] = None,
        with_units: bool = True,
        return_sum: bool = True,
    ):
        """Total z-field (screening + applied) at any point(s) in space.

        Args:
            positions: ``(m, 2)`` or ``(m, 3)`` coordinates.
            zs: z-coordinates if positions is ``(m, 2)``.
            interp_method: "linear" or "cubic".
            units: Desired units (default ``field_units``).
            with_units: Return Quantities.
            return_sum: Sum over sources instead of returning a dict.
        """
        from .solver.utils import convert_field

        device = self.device
        dtype = device.solve_dtype
        xy, z = _normalize_coordinates(positions, zs, dtype)
        fields = self.screening_field_at_position(
            xy,
            zs=z,
            vector=False,
            interp_method=interp_method,
            units=self.field_units,
            with_units=False,
            return_sum=False,
        )
        # Applied (+ other-films) field: sampled on the film mesh for
        # in-plane points inside a film, from the applied-field callable
        # everywhere else.
        applied = np.zeros(len(xy), dtype=dtype)
        covered = np.zeros(len(xy), dtype=bool)
        for name, film in device.films.items():
            inside = (z == device.layers[film.layer].z0) & film.contains_points(
                xy
            )
            covered |= inside
            if inside.any():
                applied[inside] = self.interp_field(
                    xy[inside],
                    film=name,
                    dataset="applied_field",
                    method=interp_method,
                    units=self.field_units,
                    with_units=False,
                ) + self.interp_field(
                    xy[inside],
                    film=name,
                    dataset="field_from_other_films",
                    method=interp_method,
                    units=self.field_units,
                    with_units=False,
                )
        free = ~covered
        if free.any():
            applied[free] = np.atleast_1d(
                np.squeeze(self.applied_field_func(xy[free, 0], xy[free, 1], z[free]))
            )
        fields["applied_field"] = np.atleast_1d(applied).squeeze()
        converted = {
            key: convert_field(
                val,
                units or self.field_units,
                old_units=self.field_units,
                ureg=device.ureg,
                with_units=with_units,
            )
            for key, val in fields.items()
        }
        return sum(converted.values()) if return_sum else converted

    def vector_potential_at_position(
        self,
        positions: np.ndarray,
        *,
        zs: Union[float, np.ndarray, None] = None,
        units: Optional[str] = None,
        with_units: bool = True,
        return_sum: bool = True,
    ):
        """Vector potential from device currents at any point(s) in space:
        ``A(r) = mu_0/(4 pi) int J(r') / |r - r'| d^2r'``.

        Args:
            positions: ``(m, 2)`` or ``(m, 3)`` coordinates.
            zs: z-coordinates if positions is ``(m, 2)``.
            units: Desired units (default ``field_units * length_units``).
            with_units: Return Quantities.
            return_sum: Sum over films instead of returning a dict.
        """
        from .ops.kernels import vector_potential_2d
        from .solver.solve import highest_matmul_precision
        from .solver.utils import torch_dtype

        device = self.device
        xy, z = _normalize_coordinates(positions, zs, device.solve_dtype)
        units = units or f"{self.field_units} * {device.length_units}"
        torch_device = self._resolved_torch_device()
        potentials = {}
        for name, film in device.films.items():
            layer = device.layers[film.layer]
            # The 1/|r - r'| kernel is singular for points ON the film:
            # raise when every point is in the film, warn when some are
            # (their rows are mesh-regularized at best).
            in_film = (z == layer.z0) & film.contains_points(xy)
            if in_film.all():
                raise ValueError(
                    f"Cannot evaluate vector potential inside the film ({name!r})."
                )
            if in_film.any():
                logger.warning(
                    f"vector_potential_at_position: {int(in_film.sum())} "
                    f"point(s) lie inside film {name!r} at its plane; their "
                    "rows are mesh-regularized (the continuum integral is "
                    "singular there)."
                )
            mesh = device.meshes[name]
            J = self.film_solutions[name].current_density
            like = dict(
                dtype=torch_dtype(J.dtype if J.dtype == np.float32 else np.float64),
                device=torch_device,
            )
            with highest_matmul_precision():
                Axy = vector_potential_2d(
                    torch.as_tensor(np.ascontiguousarray(xy), **like),
                    torch.as_tensor(np.ascontiguousarray(z), **like),
                    torch.as_tensor(mesh.sites, **like),
                    float(layer.z0),
                    torch.as_tensor(mesh.vertex_areas, **like),
                    torch.as_tensor(J, **like),
                )
            Axy = 4 * np.pi * Axy.cpu().numpy()
            A3 = np.concatenate([Axy, np.zeros_like(Axy[:, :1])], axis=1)
            quantity = (
                device.ureg("mu_0")
                / (4 * np.pi)
                * Quantity(A3, self.current_units)
            ).to(units)
            potentials[name] = quantity if with_units else quantity.magnitude
        return sum(potentials.values()) if return_sum else potentials

    # -- equality ------------------------------------------------------------

    def equals(self, other: Any, require_same_timestamp: bool = False) -> bool:
        """Whether two solutions are equal (optionally including the
        creation timestamp)."""
        if other is self:
            return True
        if not isinstance(other, Solution):
            return False
        same_setup = (
            self.device == other.device
            and self.field_units == other.field_units
            and self.current_units == other.current_units
            and self.circulating_currents == other.circulating_currents
            and self.terminal_currents == other.terminal_currents
            and self.applied_field_func == other.applied_field_func
            and self.vortices == other.vortices
        )
        if not same_setup:
            return False
        if require_same_timestamp and self.time_created != other.time_created:
            return False
        return self.film_solutions == other.film_solutions

    def __eq__(self, other) -> bool:
        return self.equals(other, require_same_timestamp=True)

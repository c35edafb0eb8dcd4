"""Device: a stack of layers, films and holes.

Counterpart of ``superscreen_tpu/device/device.py``: layers, films, holes,
transport terminals and abstract regions, meshing, boundary vertices and
the solve dtype.  The device has no file I/O.
"""

import logging
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .. import polygon_ops as pops
from ..units import ureg
from . import mesh_generation as mgen
from .layer import Layer
from .mesh import Mesh
from .polygon import Polygon

logger = logging.getLogger("device")

__all__ = ["Device"]

PolygonSpec = Union[Sequence[Polygon], Dict[str, Polygon]]


def _by_name(items) -> dict:
    """Normalize a sequence-or-dict of named objects into ``{name: obj}``."""
    if items is None:
        items = []
    if isinstance(items, dict):
        items = items.values()
    return {item.name: item for item in items}


def _broadcast_per_film(value, film_names):
    """Expand a scalar-or-dict meshing option into a per-film dict."""
    if isinstance(value, dict):
        return {name: value.get(name) for name in film_names}
    return dict.fromkeys(film_names, value)


def _unwrap_terminals(
    cycle: np.ndarray, sites: np.ndarray, terminals: Sequence[Polygon]
) -> np.ndarray:
    """Rolls a CCW boundary cycle so that no terminal straddles its
    start/end: a terminal spanning the wrap point shows up as a break in
    its sorted boundary positions, and rolling by the length of the
    leading run makes it contiguous."""
    for terminal in terminals:
        positions = terminal.contains_points(sites[cycle], index=True)
        breaks = np.nonzero(np.diff(positions) != 1)[0]
        if len(breaks):
            return np.roll(cycle, -(breaks[0] + 1))
    return cycle


class Device:
    """A device composed of one or more layers of thin-film superconductor.

    Args:
        name: Name of the device.
        layers: The :class:`Layer` objects making up the device.
        films: :class:`Polygon` regions of superconductor.
        holes: :class:`Polygon` holes in superconducting films.
        terminals: ``{film_name: [terminal, ...]}`` transport terminals.
        abstract_regions: Abstract :class:`Polygon` regions.
        length_units: Distance units for the coordinate system.
        solve_dtype: Float dtype used when solving the device.
    """

    ureg = ureg

    def __init__(
        self,
        name: str,
        *,
        layers: Union[Sequence[Layer], Dict[str, Layer]],
        films: PolygonSpec,
        holes: Optional[PolygonSpec] = None,
        terminals: Optional[Dict[str, List[Polygon]]] = None,
        abstract_regions: Optional[PolygonSpec] = None,
        length_units: str = "um",
        solve_dtype: Union[str, np.dtype] = "float32",
    ):
        self.name = name
        self.layers = _by_name(layers)
        self.films = _by_name(films)
        self.holes = _by_name(holes)
        self.abstract_regions = _by_name(abstract_regions)
        self.terminals: Dict[str, List[Polygon]] = dict(terminals or {})
        self.length_units = length_units
        self.solve_dtype = solve_dtype
        self.meshes: Optional[Dict[str, Mesh]] = None
        if set(self.terminals) - set(self.films):
            raise ValueError(
                "terminals.keys() must be a subset of films.keys() "
                f"({list(self.films)!r})."
            )
        # Terminals live in their film's layer by construction.
        for film_name, terms in self.terminals.items():
            for terminal in terms:
                terminal.layer = self.films[film_name].layer
        for label, group in (("film", self.films), ("hole", self.holes)):
            for polygon in group.values():
                if not polygon.is_valid:
                    raise ValueError(
                        f"The following {label} is not valid: {polygon}."
                    )
                if polygon.layer not in self.layers:
                    raise ValueError(
                        f"The following {label} is assigned to a layer that "
                        f"does not exist in the device: {polygon}."
                    )

    @property
    def solve_dtype(self) -> np.dtype:
        """Float dtype used when solving the device."""
        return self._solve_dtype

    @solve_dtype.setter
    def solve_dtype(self, dtype) -> None:
        dtype = np.dtype(dtype)
        if dtype not in (np.float32, np.float64):
            raise ValueError(f"solve_dtype must be float32 or float64, got {dtype}.")
        self._solve_dtype = dtype

    def get_polygons(self, include_terminals: bool = True) -> List[Polygon]:
        """All polygons in the device."""
        groups = [self.films, self.holes, self.abstract_regions]
        polygons = [p for group in groups for p in group.values()]
        if include_terminals:
            polygons += [t for terms in self.terminals.values() for t in terms]
        return polygons

    def polygons_by_layer(self, polygon_type: str) -> Dict[str, List[Polygon]]:
        """``{layer_name: [polygons of the given type in that layer]}`` for
        ``polygon_type`` in ``("film", "hole", "abstract", "terminal")``."""
        groups = {
            "film": self.films.values(),
            "hole": self.holes.values(),
            "abstract": self.abstract_regions.values(),
            "terminal": [t for terms in self.terminals.values() for t in terms],
        }
        chosen = list(groups[polygon_type])
        return {
            layer: [p for p in chosen if p.layer == layer] for layer in self.layers
        }

    def holes_by_film(self) -> Dict[str, List[Polygon]]:
        """``{film_name: [holes contained in that film]}``."""
        holes_in_layer = self.polygons_by_layer("hole")
        return {
            film.name: [
                hole
                for hole in holes_in_layer[film.layer]
                if film.contains_points(hole.points).all()
            ]
            for film in self.films.values()
        }

    def copy(self, with_mesh: bool = True, copy_mesh: bool = False) -> "Device":
        """Copies the device; with ``with_mesh`` the meshes are shared, or
        deep-copied if ``copy_mesh``."""
        clone = Device(
            self.name,
            layers=[layer.copy() for layer in self.layers.values()],
            films=[film.copy() for film in self.films.values()],
            holes=[hole.copy() for hole in self.holes.values()],
            terminals={
                film: [t.copy() for t in terms] for film, terms in self.terminals.items()
            },
            abstract_regions=[r.copy() for r in self.abstract_regions.values()],
            length_units=self.length_units,
            solve_dtype=self.solve_dtype,
        )
        if with_mesh and self.meshes is not None:
            if copy_mesh:
                clone.meshes = {name: mesh.copy() for name, mesh in self.meshes.items()}
            else:
                clone.meshes = self.meshes
        return clone

    # -- meshing -------------------------------------------------------------

    def make_mesh(
        self,
        buffer_factor: Union[float, Dict[str, float], None] = 0.05,
        buffer: Union[float, Dict[str, float], None] = None,
        join_style: str = "round",
        min_points: Union[int, Dict[str, int], None] = None,
        max_edge_length: Union[float, Dict[str, float], None] = None,
        preserve_boundary: bool = False,
        smooth: Union[int, Dict[str, int]] = 0,
    ) -> None:
        """Generates the triangular mesh for each film into ``self.meshes``.

        ``buffer_factor``, ``buffer``, ``min_points``, ``max_edge_length``,
        and ``smooth`` accept either a single value or a per-film dict.

        Args:
            buffer_factor: Film bounding-box buffer in units of the maximum
                film dimension (ignored if ``buffer`` is given).
            buffer: Film bounding-box buffer in ``length_units``.
            join_style: Join style for the buffered region.
            min_points: Minimum number of mesh vertices per film.
            max_edge_length: Maximum mesh edge length per film.
            preserve_boundary: Do not add vertices on the boundary (always
                true for films with terminals).
            smooth: Laplacian smoothing iterations.
        """
        names = list(self.films)
        options = {
            key: _broadcast_per_film(value, names)
            for key, value in (
                ("buffer_factor", buffer_factor),
                ("buffer", buffer),
                ("min_points", min_points),
                ("max_edge_length", max_edge_length),
                ("smooth", smooth),
            )
        }
        self.meshes = {
            name: self._mesh_film(
                name,
                join_style=join_style,
                preserve_boundary=preserve_boundary,
                **{key: per_film[name] for key, per_film in options.items()},
            )
            for name in names
        }

    def _mesh_film(
        self,
        name: str,
        *,
        buffer_factor,
        buffer,
        join_style,
        min_points,
        max_edge_length,
        preserve_boundary,
        smooth,
    ) -> Mesh:
        """Mesh a single film: optional buffered vacuum margin (never for a
        film with terminals, whose boundary is preserved), hole and
        abstract-region outlines as conforming feature rings."""
        film = self.films[name]
        has_terminals = name in self.terminals
        interior_features = [
            poly.points
            for group in ("hole", "abstract")
            for poly in self.polygons_by_layer(group)[film.layer]
            if film.contains_points(poly.points).all()
        ]
        if has_terminals or buffer == 0 or (buffer_factor is None and buffer is None):
            outer = film.points
        else:
            # Mesh a buffered bounding region so some vacuum margin around
            # the film is meshed; the film outline becomes a feature ring.
            margin = buffer if buffer is not None else buffer_factor * max(film.extents)
            buffered = pops.buffer_polygon(
                film.points, margin, join_style=join_style, mitre_limit=5.0
            )
            outer = pops.resample_polygon(buffered, len(film.points))
            interior_features.insert(0, film.points)
        points, triangles = mgen.generate_mesh(
            outer,
            feature_rings=interior_features,
            min_points=min_points,
            max_edge_length=max_edge_length,
            preserve_boundary=preserve_boundary or has_terminals,
        )
        if smooth:
            return Mesh.from_triangulation(
                points, triangles, build_operators=False
            ).smooth(smooth)
        return Mesh.from_triangulation(points, triangles)

    def boundary_vertices(self, film: str) -> np.ndarray:
        """Boundary vertex indices for a film's mesh, ordered CCW.  For a
        film with terminals the cycle is rolled so that no terminal's
        vertices straddle the start/end of the array."""
        mesh = self.meshes[film]
        cycle = mgen.boundary_vertices(mesh.sites, mesh.elements)
        return _unwrap_terminals(cycle, mesh.sites, self.terminals.get(film, []))

    # -- mutual inductance ---------------------------------------------------

    def mutual_inductance_matrix(
        self,
        hole_polygon_mapping: Optional[Dict[str, np.ndarray]] = None,
        units: str = "pH",
        all_iterations: bool = False,
        progress_bar: bool = False,
        torch_device="cuda",
        **solve_kwargs,
    ):
        """The mutual inductance matrix ``M`` of the device:
        ``M[i, j] = Phi_i / I_j`` where ``Phi_i`` is the fluxoid of the
        polygon enclosing hole ``i`` when unit current circulates hole ``j``.

        All hole columns are solved as one ``solve_many`` batch against a
        single factorization; with ``all_iterations`` the per-iteration
        history comes from that same batch.  Devices with transport
        terminals take a per-column loop over
        :func:`superscreen_tpu_torch.solve`.

        Args:
            hole_polygon_mapping: ``{hole_name: polygon_coords}`` enclosing
                polygons for the fluxoid calculation. Defaults to
                auto-generated polygons.
            units: Units for the mutual inductance.
            all_iterations: Return matrices for all ``iterations + 1``
                solutions instead of just the final one.
            progress_bar: Accepted for callers of the JAX package; no
                progress bar is shown.
            torch_device: Where the device is factorized and solved:
                ``"cuda"`` (default; raises without a card) or ``"cpu"``.
            solve_kwargs: Passed to :func:`superscreen_tpu_torch.solve`.
        """
        from ..fluxoid import make_fluxoid_polygons
        from ..ops.fem import in_polygon

        if hole_polygon_mapping is None:
            hole_polygon_mapping = make_fluxoid_polygons(self)
        for hole_name, polygon in hole_polygon_mapping.items():
            if hole_name not in self.holes:
                raise ValueError(
                    f"Hole '{hole_name}' does not exist in the device."
                )
            if not in_polygon(polygon, self.holes[hole_name].points).all():
                raise ValueError(
                    f"Hole '{hole_name}' is not completely contained "
                    f"within the given polygon."
                )

        solve_kwargs = dict(solve_kwargs)
        solve_kwargs.pop("current_units", None)
        solve_kwargs["progress_bar"] = False
        iterations = solve_kwargs.get("iterations", 1)
        # high_precision solves need float64 refinement, which the batched
        # sweep does not provide.
        use_batched = solve_kwargs.pop(
            "use_batched_solver",
            not self.terminals and not solve_kwargs.get("high_precision"),
        )
        # Single-layer devices have no inter-film coupling: iteration 0 is
        # already converged.
        n_matrices = iterations + 1 if (all_iterations and len(self.layers) > 1) else 1

        hole_names = list(self.holes)
        film_of_hole = {
            hole.name: film
            for film, film_holes in self.holes_by_film().items()
            for hole in film_holes
        }
        unit_current = self.ureg("1 mA")

        def fluxoid_column(solution) -> np.ndarray:
            """Fluxoids of every enclosing polygon for one solution, in
            ``units`` per unit circulating current."""
            column = np.zeros(len(hole_names))
            for i, name in enumerate(hole_names):
                fluxoid = solution.polygon_fluxoid(
                    hole_polygon_mapping[name], film=film_of_hole[name]
                )
                column[i] = (sum(fluxoid) / unit_current).to(units).magnitude
            return column

        matrices = np.zeros((n_matrices, len(hole_names), len(hole_names)))
        if use_batched:
            matrices = self._batched_mutuals(
                matrices, hole_names, fluxoid_column, iterations, solve_kwargs, torch_device
            )
        else:
            matrices = self._per_column_mutuals(
                matrices, hole_names, fluxoid_column, solve_kwargs, torch_device
            )
        results = [m * self.ureg(units) for m in matrices]
        return results if all_iterations else results[-1]

    def _batched_mutuals(
        self, matrices, hole_names, fluxoid_column, iterations, solve_kwargs, torch_device
    ):
        """All columns in one batched solve (one per iteration if the
        history is requested)."""
        from ..solver import factorize_model
        from ..sources import ConstantField
        from ..sweep import solve_many

        model = factorize_model(device=self, current_units="mA", torch_device=torch_device)
        want_history = len(matrices) > 1
        sweep = solve_many(
            model=model,
            applied_fields=[ConstantField(0)] * len(hole_names),
            circulating_currents=[{name: 1.0} for name in hole_names],
            field_units=solve_kwargs.get("field_units", "mT"),
            iterations=iterations if len(self.films) > 1 else 0,
            keep_history=want_history,
            torch_device=torch_device,
        )
        per_iteration = list(sweep) if want_history else [sweep]
        if len(per_iteration) < len(matrices):
            # e.g. a multi-layer device with a single film: no coupling ran,
            # so every iteration equals the converged state.
            per_iteration += [per_iteration[-1]] * (
                len(matrices) - len(per_iteration)
            )
        for it, result in enumerate(per_iteration[-len(matrices):]):
            for j in range(len(hole_names)):
                matrices[it, :, j] = fluxoid_column(result.solution(j))
        return matrices

    def _per_column_mutuals(
        self, matrices, hole_names, fluxoid_column, solve_kwargs, torch_device
    ):
        """Column-by-column loop over ``solve`` (used for terminal devices)."""
        from ..solver import factorize_model, solve

        model = None
        keep = len(matrices)
        for j, hole_name in enumerate(hole_names):
            logger.info(
                f"Evaluating {self.name!r} mutual inductance matrix "
                f"column ({j + 1}/{len(hole_names)}), source = {hole_name!r}."
            )
            if model is None:
                model = factorize_model(
                    device=self,
                    current_units="mA",
                    circulating_currents={hole_name: "1 mA"},
                    torch_device=torch_device,
                )
                I_val = model.circulating_currents[hole_name]
            else:
                model.set_circulating_currents({hole_name: I_val})
            solutions = solve(model=model, torch_device=torch_device, **solve_kwargs)[-keep:]
            for it, solution in enumerate(solutions):
                matrices[it, :, j] = fluxoid_column(solution)
        return matrices

    def __eq__(self, other) -> bool:
        """Same name, layers, films, holes, terminals, abstract regions and
        length units (the meshes and the solve dtype are not compared)."""
        if not isinstance(other, Device):
            return False
        if self is other:
            return True

        def key(device):
            def ordered(group):
                return sorted(group.values(), key=lambda p: p.name)

            return (
                device.name,
                ordered(device.layers),
                ordered(device.films),
                ordered(device.holes),
                device.terminals,
                ordered(device.abstract_regions),
                device.length_units,
            )

        return key(self) == key(other)

    def __repr__(self) -> str:
        return (
            f"Device({self.name!r}, layers={list(self.layers)}, "
            f"films={list(self.films)}, holes={list(self.holes)}, "
            f"length_units={self.length_units!r})"
        )

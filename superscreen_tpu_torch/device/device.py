"""Device: a stack of layers, films and holes.

Counterpart of ``superscreen_tpu/device/device.py``: layers, films, holes,
transport terminals and abstract regions, meshing (with the opt-in mesh
cache of :mod:`.mesh_cache`), boundary vertices, the solve dtype, the
geometric transforms, HDF5 files in the JAX package's layout and plots.
``h5py`` and matplotlib are imported only by the methods that need them.
"""

import logging
import numbers
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import polygon_ops as pops
from ..geometry import ensure_unique
from ..io import h5_context, new_group
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


def _require_xy_origin(origin) -> None:
    ok = (
        isinstance(origin, tuple)
        and len(origin) == 2
        and all(isinstance(v, numbers.Real) for v in origin)
    )
    if not ok:
        raise TypeError("Origin must be a tuple of floats (x, y).")


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


def _restore_sides(
    mesh: Mesh,
    polygons: List[Polygon],
    sides: List[np.ndarray],
    shift: Tuple[float, float],
    reach: int = 16,
):
    """Moves each site of ``mesh`` that is no longer on the side ``sides``
    gives it of one of ``polygons`` to the nearest point, at most ``reach``
    float64 ulps away in x and y, that is on the given side of all of them
    (the site's area and operators are kept: they change by ~1e-16).
    Raises ``RuntimeError`` if there is no such point: the film's index
    sets, and every solve of the moved mesh, would change."""
    now = [polygon.contains_points(mesh.sites) for polygon in polygons]
    moved = np.flatnonzero(np.any([a != b for a, b in zip(sides, now)], axis=0))
    steps = np.arange(-reach, reach + 1)
    kx, ky = (k.ravel() for k in np.meshgrid(steps, steps))
    order = np.argsort(np.abs(kx) + np.abs(ky), kind="stable")
    kx, ky = kx[order], ky[order]
    for i in moved:
        x, y = mesh.sites[i]
        candidates = np.stack([x + kx * np.spacing(x), y + ky * np.spacing(y)], axis=1)
        ok = np.all(
            [p.contains_points(candidates) == side[i] for p, side in zip(polygons, sides)], axis=0
        )
        if not ok.any():
            names = [p.name for p, a, b in zip(polygons, sides, now) if a[i] != b[i]]
            raise RuntimeError(
                f"Site {i} at ({x!r}, {y!r}) changed sides of {names} in the translation by "
                f"{shift}, and no point within {reach} ulps puts it back; translate by another "
                "shift or re-mesh."
            )
        mesh.sites[i] = candidates[np.argmax(ok)]
        if mesh.operators is not None and mesh.operators.sites is not mesh.sites:
            mesh.operators.sites[i] = mesh.sites[i]


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
        self._length_units = length_units
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
    def length_units(self) -> str:
        """Length units used for the device geometry."""
        return self._length_units

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

    @property
    def poly_points(self) -> np.ndarray:
        """All unique polygon vertices in the device (terminals excluded)."""
        stacked = np.concatenate(
            [p.points for p in self.get_polygons(include_terminals=False)]
        )
        return ensure_unique(stacked)

    def polygons_by_layer(self, polygon_type: Optional[str] = None) -> Dict[str, List[Polygon]]:
        """``{layer_name: [polygons of the given type in that layer]}`` for
        ``polygon_type`` in ``("film", "hole", "abstract", "terminal",
        "all")`` (None means ``"all"``)."""
        groups = {
            "film": lambda: self.films.values(),
            "hole": lambda: self.holes.values(),
            "abstract": lambda: self.abstract_regions.values(),
            "terminal": lambda: [t for terms in self.terminals.values() for t in terms],
            "all": lambda: self.get_polygons(),
        }
        key = (polygon_type or "all").lower()
        if key not in groups:
            raise ValueError(
                f"Invalid polygon type ({polygon_type}). Expected one of {tuple(groups)!r}."
            )
        chosen = list(groups[key]())
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

    # -- transforms ----------------------------------------------------------

    def _meshless_copy_for(self, method: str) -> "Device":
        """A mesh-free copy, warning if a mesh is being discarded."""
        if self.meshes:
            logger.warning(
                f"Calling device.{method} on a device whose mesh already "
                f"exists returns a new device with no mesh. Call "
                f"new_device.make_mesh() to generate the mesh for the new "
                f"device."
            )
        return self.copy(with_mesh=False)

    def scale(
        self, xfact: float = 1, yfact: float = 1, origin: Tuple[float, float] = (0, 0)
    ) -> "Device":
        """Returns a new device (without a mesh) with its polygons scaled
        horizontally and/or vertically about ``origin`` (negative factors
        reflect)."""
        _require_xy_origin(origin)
        scaled = self._meshless_copy_for("scale()")
        for polygon in scaled.get_polygons():
            polygon.scale(xfact=xfact, yfact=yfact, origin=origin, inplace=True)
        return scaled

    def rotate(self, degrees: float, origin: Tuple[float, float] = (0, 0)) -> "Device":
        """Returns a new device (without a mesh) rotated counterclockwise by
        ``degrees`` about ``origin``."""
        _require_xy_origin(origin)
        rotated = self._meshless_copy_for("rotate()")
        for polygon in rotated.get_polygons():
            polygon.rotate(degrees, origin=origin, inplace=True)
        return rotated

    def mirror_layers(self, about_z: float = 0.0) -> "Device":
        """Returns a new device (without a mesh) with its layers mirrored
        about the plane ``z = about_z``."""
        mirrored = self._meshless_copy_for("mirror_layers()")
        for layer in mirrored.layers.values():
            layer.z0 = about_z - layer.z0
        return mirrored

    def translate(
        self,
        dx: float = 0,
        dy: float = 0,
        dz: float = 0,
        inplace: bool = False,
    ) -> "Device":
        """Translates the polygons, the meshes (kept, with their sites
        shifted; see :meth:`Mesh.translate_sites`) and the layer heights.

        Every site stays on its side of every outline of its layer: a
        site on a hole's or a film's outline, which the shifted outline
        and the shifted site round apart, would otherwise change sides and
        the film's index sets with it (the JAX package's ``translate`` lets
        that happen).  Such a site is moved by the few float64 ulps that
        put it back (:func:`_restore_sides`).

        Args:
            dx, dy, dz: The shift in ``length_units``.
            inplace: Shift this device instead of a deep copy.
        """
        target = self if inplace else self.copy(with_mesh=True, copy_mesh=True)
        sides = {film: self._sides(film) for film in (self.meshes or {})}
        for polygon in target.get_polygons():
            polygon.translate(dx, dy, inplace=True)
        for film, mesh in (target.meshes or {}).items():
            mesh.translate_sites(dx, dy)
            _restore_sides(mesh, target._layer_polygons(film), sides[film], (dx, dy))
        if dz:
            for layer in target.layers.values():
                layer.z0 += dz
        return target

    def _layer_polygons(self, film: str) -> List[Polygon]:
        return self.polygons_by_layer()[self.films[film].layer]

    def _sides(self, film: str) -> List[np.ndarray]:
        """For each polygon of the film's layer, which of its mesh's sites
        it contains."""
        sites = self.meshes[film].sites
        return [polygon.contains_points(sites) for polygon in self._layer_polygons(film)]

    @contextmanager
    def translation(self, dx: float, dy: float, dz: float = 0):
        """Context manager that translates the device in place and back."""
        self.translate(dx, dy, dz=dz, inplace=True)
        try:
            yield
        finally:
            self.translate(-dx, -dy, dz=-dz, inplace=True)

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
        **mesh_kwargs,
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
            mesh_kwargs: Passed on to
                :func:`superscreen_tpu_torch.device.mesh_generation.generate_mesh`
                for every film (``min_angle``, ``extra_points``, ...), and
                part of the mesh-cache key.
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
                **mesh_kwargs,
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
        **mesh_kwargs,
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
        # Opt-in triangulation cache (SUPERSCREEN_TPU_MESH_CACHE=dir): the
        # final (post-smoothing) triangulation is keyed on the exact input
        # geometry and meshing parameters, extra meshing keywords included,
        # with the JAX package's key: the two packages share entries.
        from . import mesh_cache

        cache_params = dict(
            min_points=min_points,
            max_edge_length=max_edge_length,
            preserve_boundary=bool(preserve_boundary or has_terminals),
            smooth=int(smooth or 0),
            extra=repr(sorted(mesh_kwargs.items())),
        )
        key = None
        if mesh_cache.cache_dir() is not None:
            key = mesh_cache.cache_key(outer, interior_features, cache_params)
            cached = mesh_cache.load(key)
            if cached is not None:
                return Mesh.from_triangulation(*cached)
        points, triangles = mgen.generate_mesh(
            outer,
            feature_rings=interior_features,
            min_points=min_points,
            max_edge_length=max_edge_length,
            boundary=None,
            convex_hull=False,
            preserve_boundary=preserve_boundary or has_terminals,
            **mesh_kwargs,
        )
        if smooth:
            mesh = Mesh.from_triangulation(points, triangles, build_operators=False).smooth(smooth)
        else:
            mesh = Mesh.from_triangulation(points, triangles)
        if key is not None:
            mesh_cache.store(key, mesh.sites, mesh.elements)
        return mesh

    def boundary_vertices(self, film: str) -> np.ndarray:
        """Boundary vertex indices for a film's mesh, ordered CCW.  For a
        film with terminals the cycle is rolled so that no terminal's
        vertices straddle the start/end of the array."""
        mesh = self.meshes[film]
        cycle = mgen.boundary_vertices(mesh.sites, mesh.elements)
        return _unwrap_terminals(cycle, mesh.sites, self.terminals.get(film, []))

    def mesh_stats_dict(self) -> Optional[Dict[str, Dict[str, Union[int, float]]]]:
        """Mesh information for all meshes (None without a mesh)."""
        if self.meshes is None:
            return None
        return {name: mesh.stats() for name, mesh in self.meshes.items()}

    def mesh_stats(self, precision: int = 3):
        """An HTML table of mesh statistics (for notebooks)."""
        all_stats = self.mesh_stats_dict()
        if all_stats is None:
            return None
        rows = [("", "<b>length_units</b>", repr(self.length_units))]
        for name, stats in all_stats.items():
            label = f"<b>{name!r}</b>"
            for key, value in stats.items():
                shown = f"{value:.{precision}e}" if isinstance(value, float) else value
                rows.append((label, f"<b>{key}</b>", shown))
                label = ""  # only print the mesh name on its first row
        body = "".join(
            "<tr>" + "".join(f"<td>{col}</td>" for col in row) + "</tr>" for row in rows
        )
        html = f"<table><tr><h2>Mesh Statistics</h2></tr>{body}</table>"
        try:
            from IPython.display import HTML

            return HTML(html)
        except ImportError:
            return html

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

    # -- plotting ------------------------------------------------------------

    def _figure_axes(self, count, ax, subplots, figsize, max_cols=2):
        """Shared fig/axes setup for the plotting helpers.  Returns
        ``(fig, axes_array, subplots)`` where axes_array has one entry per
        plotted item (repeated when everything shares one axis)."""
        from ..io import require

        plt = require("matplotlib.pyplot")
        if ax is not None:
            return ax.get_figure(), np.array([ax] * count), False
        if subplots:
            from ..visualization import auto_grid

            fig, axes = auto_grid(
                count, max_cols=max_cols, figsize=figsize, constrained_layout=True
            )
            return fig, axes, True
        fig, one = plt.subplots(figsize=figsize, constrained_layout=True)
        return fig, np.array([one] * count), False

    def _label_axis(self, ax) -> None:
        ax.set_xlabel(f"$x$ [{self.length_units}]")
        ax.set_ylabel(f"$y$ [{self.length_units}]")
        ax.set_aspect("equal")

    def plot_polygons(
        self,
        ax=None,
        subplots: bool = False,
        legend: bool = False,
        figsize: Optional[Tuple[float, float]] = None,
        **kwargs,
    ):
        """Plots all the device's polygons."""
        if len(self.films) > 1 and subplots and ax is not None:
            raise ValueError(
                "Axes may not be provided if subplots is True and the device "
                "has multiple films."
            )
        fig, axes, subplots = self._figure_axes(
            len(self.films), ax, subplots, figsize
        )
        holes_in_film = self.holes_by_film()
        for axis, (name, film) in zip(axes.flat, self.films.items()):
            for polygon in (
                [film] + holes_in_film[name] + self.terminals.get(name, [])
            ):
                polygon.plot(ax=axis, **kwargs)
            if subplots:
                axis.set_title(name)
            if legend:
                axis.legend(bbox_to_anchor=(1, 1), loc="upper left")
            self._label_axis(axis)
        return fig, axes if subplots else axes[0]

    def plot_mesh(
        self,
        ax=None,
        subplots: bool = False,
        figsize: Optional[Tuple[float, float]] = None,
        show_sites: bool = False,
        show_edges: bool = True,
        site_color=None,
        edge_color=None,
        linewidth: float = 0.75,
        linestyle: str = "-",
        marker: str = ".",
    ):
        """Plots all the device's meshes."""
        if self.meshes is None:
            raise ValueError(
                "Mesh doesn't exist. Run Device.make_mesh() to generate one."
            )
        if len(self.films) > 1 and subplots and ax is not None:
            raise ValueError(
                "Axes may not be provided if subplots is True and the device "
                "has multiple films."
            )
        fig, axes, subplots = self._figure_axes(
            len(self.films), ax, subplots, figsize
        )
        for i, (axis, (name, mesh)) in enumerate(zip(axes.flat, self.meshes.items())):
            mesh.plot(
                ax=axis,
                show_sites=show_sites,
                show_edges=show_edges,
                site_color=site_color if site_color is not None else f"C{i}",
                edge_color=edge_color if edge_color is not None else f"C{i}",
                linestyle=linestyle,
                linewidth=linewidth,
                marker=marker,
            )
            if subplots:
                axis.set_title(name)
            self._label_axis(axis)
        return fig, axes if subplots else axes[0]

    def patches(self) -> Dict[str, Dict[str, "object"]]:
        """``{layer_name: {film_name: PathPatch}}`` for device visualization."""
        from ..io import require

        PathPatch = require("matplotlib.patches").PathPatch
        Path = require("matplotlib.path").Path

        def ring_path(points, reverse=False):
            coords = points.tolist()
            if reverse:
                coords = coords[::-1]
            codes = [Path.MOVETO] + [Path.LINETO] * (len(coords) - 2) + [
                Path.CLOSEPOLY
            ]
            return coords, codes

        holes_in_layer = self.polygons_by_layer("hole")
        patches: Dict[str, Dict[str, object]] = {}
        for layer, regions in self.polygons_by_layer().items():
            hole_names = {h.name for h in holes_in_layer[layer]}
            layer_patches = {}
            for region in regions:
                if region.name in hole_names:
                    continue
                coords, codes = ring_path(region.points)
                is_abstract = region.name in self.abstract_regions
                for hole in holes_in_layer[layer]:
                    if not is_abstract and region.contains_points(
                        hole.points
                    ).all():
                        # Punch the hole by appending its ring with reversed
                        # orientation.
                        hole_coords, hole_codes = ring_path(
                            hole.points, reverse=True
                        )
                        coords += hole_coords
                        codes += hole_codes
                layer_patches[region.name] = PathPatch(Path(coords, codes))
            if layer_patches:
                patches[layer] = layer_patches
        return patches

    def draw(
        self,
        ax=None,
        subplots: bool = False,
        max_cols: int = 3,
        legend: bool = False,
        figsize: Optional[Tuple[float, float]] = None,
        alpha: float = 0.5,
        exclude: Optional[Union[str, List[str]]] = None,
        layer_order: str = "increasing",
    ):
        """Draws all polygons in the device as matplotlib patches."""
        if len(self.layers) > 1 and subplots and ax is not None:
            raise ValueError(
                "Axes may not be provided if subplots is True and the device "
                "has multiple layers."
            )
        if layer_order.lower() not in ("increasing", "decreasing"):
            raise ValueError(
                f"Invalid layer_order: {layer_order}. "
                f"Valid layer orders are ('increasing', 'decreasing')."
            )
        if isinstance(exclude, str):
            exclude = [exclude]
        exclude = set(exclude or [])

        layers_by_height = sorted(self.layers.values(), key=lambda la: la.z0)
        layer_names = [la.name for la in layers_by_height]
        if layer_order.lower() == "decreasing":
            layer_names.reverse()

        fig, axes, subplots = self._figure_axes(
            len(self.layers), ax, subplots, figsize, max_cols=max_cols
        )
        # Common axis limits with a 10% margin around all polygon vertices.
        x, y = self.poly_points.T
        cx, cy = (x.min() + x.max()) / 2, (y.min() + y.max()) / 2
        half_w, half_h = 0.55 * np.ptp(x), 0.55 * np.ptp(y)

        patches = self.patches()
        used_axes = set()
        labels: List[str] = []
        handles: List[object] = []
        for i, (layer, axis) in enumerate(zip(layer_names, axes.flat)):
            axis.grid(False)
            axis.set_xlim(cx - half_w, cx + half_w)
            axis.set_ylim(cy - half_h, cy + half_h)
            self._label_axis(axis)
            if subplots:
                labels, handles = [], []
            first_in_layer = True
            for name, patch in patches.get(layer, {}).items():
                if name in exclude or name in self.holes:
                    continue
                patch.set_facecolor(f"C{i}")
                patch.set_alpha(alpha)
                axis.add_artist(patch)
                used_axes.add(axis)
                if first_in_layer:
                    labels.append(layer)
                    handles.append(patch)
                    first_in_layer = False
            if subplots:
                axis.set_title(layer)
                if legend:
                    axis.legend(
                        handles, labels, bbox_to_anchor=(1, 1), loc="upper left"
                    )
        if subplots:
            for axis in fig.axes:
                if axis not in used_axes:
                    fig.delaxes(axis)
            return fig, axes
        if legend:
            axes[0].legend(handles, labels, bbox_to_anchor=(1, 1), loc="upper left")
        return fig, axes[0]

    # -- serialization -------------------------------------------------------

    def to_hdf5(
        self,
        path_or_group,
        save_mesh: bool = True,
        compress: bool = True,
    ) -> None:
        """Serializes the device to an HDF5 file or ``h5py.Group``, in the
        JAX package's layout."""
        with h5_context(path_or_group, "x") as root:
            root.attrs.update(
                name=self.name,
                length_units=self.length_units,
                solve_dtype=str(self.solve_dtype),
            )
            groups = {
                "layers": self.layers,
                "films": self.films,
                "holes": self.holes,
                "abstract_regions": self.abstract_regions,
            }
            for group_name, members in groups.items():
                grp = new_group(root, group_name)
                for name, member in members.items():
                    member.to_hdf5(new_group(grp, name))
            terminals_grp = new_group(root, "terminals")
            for film_name, terms in self.terminals.items():
                film_grp = new_group(terminals_grp, film_name)
                for i, terminal in enumerate(terms):
                    terminal.to_hdf5(new_group(film_grp, str(i)))
            if save_mesh and self.meshes:
                mesh_grp = new_group(root, "mesh")
                for name, mesh in self.meshes.items():
                    mesh.to_hdf5(new_group(mesh_grp, name), compress=compress)

    @staticmethod
    def from_hdf5(path_or_group) -> "Device":
        """Loads a device from an HDF5 file or ``h5py.Group`` (written by
        either package)."""
        with h5_context(path_or_group, "r") as root:

            def load_polygons(group_name):
                return [Polygon.from_hdf5(g) for g in root[group_name].values()]

            terminals = {
                film: [
                    Polygon.from_hdf5(grp[str(i)]) for i in range(len(grp))
                ]
                for film, grp in root["terminals"].items()
            }
            device = Device(
                name=root.attrs["name"],
                layers=[Layer.from_hdf5(g) for g in root["layers"].values()],
                films=load_polygons("films"),
                holes=load_polygons("holes"),
                terminals=terminals,
                abstract_regions=load_polygons("abstract_regions"),
                length_units=root.attrs["length_units"],
                solve_dtype=root.attrs["solve_dtype"],
            )
            if "mesh" in root:
                device.meshes = {
                    name: Mesh.from_hdf5(grp)
                    for name, grp in root["mesh"].items()
                }
            return device

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

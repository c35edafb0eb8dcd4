"""Planar polygon primitive.

Counterpart of ``superscreen_tpu/device/polygon.py``.  Point queries use
:func:`points_in_ring`, a crossing test (in the geometry core, with a
NumPy twin) that reproduces matplotlib's ``Path.contains_points``
decision for points on the boundary, so mesh
index sets agree with the JAX package exactly; a nonzero ``radius`` tests
against the outline offset by ``radius / 2`` with mitred corners
(:func:`offset_ring`), as matplotlib's stroked contour does.  Plotting and
``path`` import matplotlib, and the HDF5 methods take an open ``h5py``
group; neither is imported by this module.
"""

import logging
from copy import deepcopy
from typing import Iterable, Optional, Tuple, Union

import numpy as np

from .. import native
from .. import polygon_ops as ops
from .. import tracing
from ..geometry import close_curve
from ..geometry import rotate as rotate_coords

logger = logging.getLogger("device")

__all__ = ["Polygon", "offset_ring", "points_in_ring", "points_in_ring_plain"]

PolygonType = Union["Polygon", np.ndarray]

#: Boolean operations understood by :meth:`Polygon._fold`.
_BOOLEAN_OPS = frozenset(
    {"union", "intersection", "difference", "symmetric_difference"}
)


def points_in_ring(ring: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Crossing-number test of ``points`` against the closed ``ring``, as
    matplotlib decides it (see :func:`points_in_ring_plain`): by the
    geometry core (:func:`superscreen_tpu_torch.native.points_in_ring`),
    or by the NumPy loop when ``SUPERSCREEN_TPU_NATIVE=0``.  Both give the
    same mask, bit for bit."""
    if native.available():
        return native.points_in_ring(ring, points)
    return points_in_ring_plain(ring, points)


def points_in_ring_plain(ring: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Crossing-number test of ``points`` against the closed ``ring``.

    The arithmetic is that of matplotlib's ``point_in_path_impl``
    (``src/_path.h``) for a closed path with ``radius=0``: per edge
    ``v0 -> v1``, a point with ``(y1 >= ty) != (y0 >= ty)`` toggles when
    ``((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == (y1 >= ty)``.
    Evaluating the same float64 expressions decides points that lie on an
    edge (hole and film outlines are mesh vertices) the same way.

    Args:
        ring: ``(m, 2)`` vertices; the last vertex closes back to the first.
        points: ``(n, 2)`` query coordinates.

    Returns:
        ``(n,)`` boolean mask.
    """
    ring = np.asarray(ring, dtype=float)
    points = np.atleast_2d(np.asarray(points, dtype=float))
    tx, ty = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), dtype=bool)
    if len(ring) < 3:
        return inside
    # A closed path's last vertex is replaced by its first (CLOSEPOLY).
    verts = np.concatenate([ring[:-1], ring[:1]], axis=0)
    yflag0 = verts[0, 1] >= ty
    for (x0, y0), (x1, y1) in zip(verts[:-1], verts[1:]):
        yflag1 = y1 >= ty
        crosses = (yflag0 != yflag1) & (
            ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1
        )
        inside ^= crosses
        yflag0 = yflag1
    return inside


def offset_ring(ring: np.ndarray, distance: float) -> np.ndarray:
    """The closed CCW ``ring`` with every edge moved ``distance`` along its
    outward normal (inward if negative), joined as matplotlib joins them.

    This is the outline of the contour matplotlib strokes for
    ``Path.contains_points(..., radius=r)``: Anti-Grain Geometry's
    ``vcgen_contour`` at width ``r`` moves each edge by ``r / 2``.  At a
    corner where the offset edges part (an outer join) they meet in a
    mitre, cut where it would reach further than 4 ``|distance|`` from the
    vertex; where they overlap (an inner join) they meet in a mitre only
    if it stays within the shorter edge's length (at least 1.01
    ``|distance|``) of the vertex, else in a bevel; a straight vertex gives
    one point (``agg_math_stroke.h``, ``calc_join`` and
    ``calc_miter`` with AGG's default limits).
    """
    verts = np.asarray(ring, dtype=float)
    if np.array_equal(verts[0], verts[-1]):
        verts = verts[:-1]
    edges = np.roll(verts, -1, axis=0) - verts
    normals = np.stack([edges[:, 1], -edges[:, 0]], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    width = abs(distance)
    out = []
    # Vertex i joins edge i - 1 (normal a) and edge i (normal b).
    for v, e0, e1, a, b in zip(
        verts, np.roll(edges, 1, axis=0), edges, np.roll(normals, 1, axis=0), normals
    ):
        p0, p1 = v + distance * a, v + distance * b
        turn = e0[0] * e1[1] - e0[1] * e1[0]
        if turn == 0 or 1.0 + a @ b <= 0:
            out.append(p0)
            continue
        tip = v + distance * (a + b) / (1.0 + a @ b)
        reach = np.linalg.norm(tip - v)
        if turn * distance < 0:  # inner join
            limit = max(min(np.linalg.norm(e0), np.linalg.norm(e1)), 1.01 * width)
            out.extend([tip] if reach <= limit else [p0, p1])
        elif reach <= 4.0 * width:
            out.append(tip)
        else:
            bevel = np.linalg.norm(0.5 * (p0 + p1) - v)
            k = (4.0 * width - bevel) / (reach - bevel)
            out.extend([p0 + (tip - p0) * k, p1 + (tip - p1) * k])
    out = np.asarray(out)
    return np.concatenate([out, out[:1]], axis=0)


def _is_simple(ring: np.ndarray) -> bool:
    """:func:`polygon_ops.is_simple_polygon`, counted as one
    :data:`~superscreen_tpu_torch.tracing.POLYGON_CHECKS`."""
    tracing.count(tracing.POLYGON_CHECKS)
    return ops.is_simple_polygon(ring)


def _coerce_ring(points) -> np.ndarray:
    """Normalize any accepted vertex input to a closed CCW ``(n, 2)`` ring,
    raising ``ValueError`` for non-simple or degenerate boundaries."""
    if isinstance(points, Polygon):
        points = points.points
    ring = np.asarray(points, dtype=float)
    if ring.ndim != 2 or ring.shape[-1] != 2:
        raise ValueError(f"Expected shape (n, 2), but got {ring.shape}.")
    ring = ops.orient_ccw(ring)
    if len(ring) < 3 or not _is_simple(ring):
        raise ValueError(
            "The given points do not define a valid simply-connected "
            "polygon (the boundary may be self-intersecting or degenerate)."
        )
    return close_curve(ring)


def _anchor_point(ring: np.ndarray, origin) -> np.ndarray:
    """Resolve a transform origin: literal (x, y), bounding-box "center",
    or mass "centroid"."""
    if not isinstance(origin, str):
        return np.asarray(origin, dtype=float)
    if origin == "center":
        return 0.5 * (ring.min(axis=0) + ring.max(axis=0))
    if origin == "centroid":
        return ops.centroid(ring)
    raise ValueError(f"Invalid origin: {origin!r}.")


class Polygon:
    """A simply-connected region assigned to a :class:`Layer`.

    The ring's simplicity verdict is kept with the bytes of the ring that
    passed it: setting :attr:`points` checks the ring once, copies and
    pickles carry the verdict, and :attr:`is_valid` checks again only when
    the ring's bytes have changed since (an edit in place).

    Args:
        name: Name of the polygon.
        layer: Name of the layer in which the polygon is located.
        points: ``(n, 2)`` vertex array or another :class:`Polygon`.
    """

    __slots__ = ("name", "layer", "_points", "_simple_bytes")

    def __init__(
        self,
        name: Optional[str] = None,
        *,
        layer: Optional[str] = None,
        points: PolygonType,
    ):
        self.name = name
        self.layer = layer
        self.points = points

    # -- vertices --------------------------------------------------------

    @property
    def points(self) -> np.ndarray:
        """Closed, CCW-oriented ``(n, 2)`` vertex array."""
        return self._points

    @points.setter
    def points(self, points) -> None:
        self._points = _coerce_ring(points)
        # The closed ring opens back to the ring that passed the check.
        self._simple_bytes = self._points.tobytes()

    @property
    def polygon(self) -> np.ndarray:
        """Alias of :attr:`points` (the JAX package's alias; its reference
        returns a shapely object here)."""
        return self._points

    @property
    def path(self):
        """The boundary as a :class:`matplotlib.path.Path` (needs
        matplotlib)."""
        from ..io import require

        return require("matplotlib.path").Path(self._points, closed=True)

    def set_name(self, name: Optional[str]) -> "Polygon":
        """Renames the polygon; returns ``self`` for chaining."""
        self.name = name
        return self

    def set_layer(self, layer: Optional[str]) -> "Polygon":
        """Re-assigns the polygon's layer; returns ``self`` for chaining."""
        self.layer = layer
        return self

    @property
    def is_valid(self) -> bool:
        """Whether the polygon is fully specified (named, on a layer, and
        geometrically simple).  The simplicity verdict is cached against the
        ring's bytes: the ring is checked again only if they differ from
        those of the ring that last passed."""
        if self.name is None or self.layer is None:
            return False
        ring = self._points.tobytes()
        # A polygon unpickled from before the verdict was kept has no slot.
        if ring == getattr(self, "_simple_bytes", None):
            return True
        if not _is_simple(self._points):
            return False
        self._simple_bytes = ring
        return True

    @property
    def area(self) -> float:
        """Enclosed area."""
        return ops.polygon_area(self._points)

    @property
    def extents(self) -> Tuple[float, float]:
        """Bounding-box side lengths ``(Delta_x, Delta_y)``."""
        span = self._points.max(axis=0) - self._points.min(axis=0)
        return float(span[0]), float(span[1])

    # -- point queries ---------------------------------------------------

    def _hit_mask(self, points: np.ndarray, radius: float) -> np.ndarray:
        ring = self._points if radius == 0 else offset_ring(self._points, radius / 2)
        return points_in_ring(ring, points)

    def contains_points(
        self,
        points: np.ndarray,
        index: bool = False,
        radius: float = 0,
    ) -> Union[bool, np.ndarray]:
        """Tests which of ``points`` fall inside the polygon (points on the
        outline are decided as by matplotlib, see :func:`points_in_ring`).

        Args:
            points: ``(n, 2)`` query coordinates.
            index: Return the indices of the hits instead of a boolean mask.
            radius: Signed margin: the outline is moved out by
                ``radius / 2`` (in if negative) first, as matplotlib's
                ``Path.contains_points`` does (see :func:`offset_ring`).
        """
        mask = self._hit_mask(points, radius)
        return np.flatnonzero(mask) if index else mask

    def on_boundary(
        self, points: np.ndarray, radius: float = 1e-3, index: bool = False
    ):
        """Tests which of ``points`` lie near the boundary: inside the
        outline grown by ``radius`` and outside the outline shrunk by it
        (each moved by ``radius / 2``, as in :meth:`contains_points`)."""
        mask = self._hit_mask(points, radius) & ~self._hit_mask(points, -radius)
        return np.flatnonzero(mask) if index else mask

    # -- meshing ---------------------------------------------------------

    def make_mesh(
        self,
        min_points: Optional[int] = None,
        max_edge_length: Optional[float] = None,
        convex_hull: bool = False,
        smooth: int = 0,
        build_operators: bool = False,
        **mesh_kwargs,
    ):
        """Triangulates the polygon into a :class:`Mesh`.

        Args:
            min_points: Minimum number of mesh vertices.
            max_edge_length: Maximum edge length in the mesh.
            convex_hull: Mesh the full convex hull instead of the interior.
            smooth: Number of Laplacian smoothing passes.
            build_operators: Also build the :class:`MeshOperators`.
            mesh_kwargs: Passed on to
                :func:`superscreen_tpu_torch.device.mesh_generation.generate_mesh`.
        """
        from .mesh import Mesh
        from .mesh_generation import generate_mesh

        sites, elements = generate_mesh(
            self._points,
            min_points=min_points,
            max_edge_length=max_edge_length,
            convex_hull=convex_hull,
            **mesh_kwargs,
        )
        mesh = Mesh.from_triangulation(
            sites, elements, build_operators=build_operators
        )
        return mesh.smooth(smooth, build_operators=build_operators)

    # -- affine transforms -----------------------------------------------

    def _remapped(self, fn, inplace: bool) -> "Polygon":
        """Applies ``fn(vertices) -> vertices`` to ``self`` or a copy."""
        target = self if inplace else self.copy()
        target.points = fn(self._points)
        return target

    def rotate(
        self,
        degrees: float,
        origin: Union[str, Tuple[float, float]] = (0.0, 0.0),
        inplace: bool = False,
    ) -> "Polygon":
        """Rotates CCW by ``degrees`` about ``origin``."""
        pivot = _anchor_point(self._points, origin)
        return self._remapped(
            lambda p: rotate_coords(p - pivot, degrees) + pivot, inplace
        )

    def translate(
        self, dx: float = 0.0, dy: float = 0.0, inplace: bool = False
    ) -> "Polygon":
        """Shifts the polygon by ``(dx, dy)``."""
        shift = np.array([dx, dy], dtype=float)
        return self._remapped(lambda p: p + shift, inplace)

    def scale(
        self,
        xfact: float = 1.0,
        yfact: float = 1.0,
        origin: Union[str, Tuple[float, float]] = (0, 0),
        inplace: bool = False,
    ) -> "Polygon":
        """Scales by ``(xfact, yfact)`` about ``origin``."""
        pivot = _anchor_point(self._points, origin)
        gain = np.array([xfact, yfact], dtype=float)
        return self._remapped(lambda p: (p - pivot) * gain + pivot, inplace)

    # -- boolean algebra -------------------------------------------------

    def _join_via(self, other: PolygonType, operation: str) -> np.ndarray:
        """One boolean step against a single other polygon-like object."""
        if operation not in _BOOLEAN_OPS:
            raise ValueError(
                f"Unknown operation: {operation}. "
                f"Valid operations are {tuple(sorted(_BOOLEAN_OPS))}."
            )
        if isinstance(other, Polygon):
            clip = other.points
        else:
            clip = np.asarray(other, dtype=float)
            if clip.ndim != 2 or clip.shape[-1] != 2:
                raise TypeError(
                    f"Expected a Polygon or shape (n, 2) array, got {other!r}."
                )
        try:
            return ops.boolean_op(self._points, clip, operation)
        except ops.PolygonOpError as err:
            raise ValueError(
                f"The {operation} of the two polygons is not a valid polygon "
                f"for the following reason: {err}."
            ) from err

    def _fold(self, operation: str, others, name: Optional[str]) -> "Polygon":
        """Left-folds ``operation`` over ``others``, threading name/layer."""
        acc = self.copy()
        for other in others:
            acc = Polygon(
                name=name or self.name,
                layer=self.layer,
                points=acc._join_via(other, operation),
            )
        return acc

    def union(self, *others: PolygonType, name: Optional[str] = None) -> "Polygon":
        """The union of this polygon with zero or more others."""
        return self._fold("union", others, name)

    def intersection(
        self, *others: PolygonType, name: Optional[str] = None
    ) -> "Polygon":
        """The intersection of this polygon with zero or more others."""
        return self._fold("intersection", others, name)

    def difference(
        self,
        *others: PolygonType,
        symmetric: bool = False,
        name: Optional[str] = None,
    ) -> "Polygon":
        """The (symmetric) difference of this polygon and zero or more
        others."""
        op = "symmetric_difference" if symmetric else "difference"
        return self._fold(op, others, name)

    @classmethod
    def from_union(
        cls,
        items: Iterable[PolygonType],
        *,
        name: Optional[str] = None,
        layer: Optional[str] = None,
    ) -> "Polygon":
        """Builds one polygon as the union of ``items``."""
        return cls._from_fold("union", items, name, layer)

    @classmethod
    def from_intersection(
        cls,
        items: Iterable[PolygonType],
        *,
        name: Optional[str] = None,
        layer: Optional[str] = None,
    ) -> "Polygon":
        """Builds one polygon as the intersection of ``items``."""
        return cls._from_fold("intersection", items, name, layer)

    @classmethod
    def from_difference(
        cls,
        items: Iterable[PolygonType],
        *,
        name: Optional[str] = None,
        layer: Optional[str] = None,
        symmetric: bool = False,
    ) -> "Polygon":
        """Builds one polygon as the (symmetric) difference of ``items``."""
        op = "symmetric_difference" if symmetric else "difference"
        return cls._from_fold(op, items, name, layer)

    @classmethod
    def _from_fold(cls, operation, items, name, layer) -> "Polygon":
        head, *tail = items
        return cls(name=name, layer=layer, points=head)._fold(operation, tail, name)

    # -- offsetting / resampling -----------------------------------------

    def buffer(
        self,
        distance: float,
        join_style: Union[str, int] = "mitre",
        mitre_limit: float = 5.0,
        single_sided: bool = False,
        as_polygon: bool = True,
    ) -> Union[np.ndarray, "Polygon"]:
        """Offsets the boundary outward by ``distance`` (inward if
        negative), then resamples to at least the original vertex count.
        ``single_sided`` is accepted, as by the JAX package, and not used:
        the offset of a closed ring is one-sided already."""
        offset_ring = ops.buffer_polygon(
            self._points,
            distance,
            join_style=join_style,
            mitre_limit=mitre_limit,
        )
        out = Polygon(
            name=f"{self.name}", layer=self.layer, points=offset_ring
        ).resample(max(len(offset_ring), len(self._points)))
        return out if as_polygon else out.points

    def resample(self, num_points: Optional[int] = None) -> "Polygon":
        """Redistributes vertices ~uniformly along the boundary."""
        if num_points is None:
            num_points = len(self._points)
        if not num_points:
            return self.copy()
        ring = ops.resample_polygon(self._points, num_points - 1)
        return Polygon(name=self.name, layer=self.layer, points=ring)

    # -- misc ------------------------------------------------------------

    def plot(self, ax=None, **kwargs):
        """Draws the boundary on a matplotlib Axes (created if needed)."""
        from ..io import require

        if ax is None:
            _, ax = require("matplotlib.pyplot").subplots()
        ax.plot(*self._points.T, **dict(kwargs, label=self.name))
        ax.set_aspect("equal")
        return ax

    def copy(self) -> "Polygon":
        return deepcopy(self)

    def __repr__(self) -> str:
        name = None if self.name is None else f"{self.name!r}"
        layer = None if self.layer is None else f"{self.layer!r}"
        return (
            f"{type(self).__name__}(name={name}, layer={layer}, "
            f"points=<ndarray: shape={self._points.shape}>)"
        )

    def __eq__(self, other) -> bool:
        if other is self:
            return True
        if not isinstance(other, Polygon):
            return False
        if (self.name, self.layer) != (other.name, other.layer):
            return False
        return self._points.shape == other._points.shape and np.allclose(
            self._points, other._points
        )

    def to_hdf5(self, h5group) -> None:
        """Writes the polygon into ``h5group`` (an ``h5py.Group``): name and
        layer as attributes, the vertices as the ``points`` dataset."""
        for attr in ("name", "layer"):
            value = getattr(self, attr)
            if value:
                h5group.attrs[attr] = value
        h5group["points"] = self._points

    @staticmethod
    def from_hdf5(h5group) -> "Polygon":
        """Reads a polygon written by :meth:`to_hdf5`."""
        return Polygon(
            name=h5group.attrs.get("name", None),
            layer=h5group.attrs.get("layer", None),
            points=np.asarray(h5group["points"]),
        )

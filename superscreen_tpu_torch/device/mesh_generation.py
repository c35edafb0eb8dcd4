"""Triangular mesh generation (host-side NumPy and SciPy).

Counterpart of ``superscreen_tpu/device/mesh_generation.py``: the same
boundary-conforming Delaunay construction (densified rings, hexagonal
lattice fill, Laplacian smoothing, refinement loop), triangulated by the
geometry core's Bowyer-Watson routine (:mod:`superscreen_tpu_torch.native`,
the JAX package's default) or, with ``SUPERSCREEN_TPU_NATIVE=0``, by
SciPy's Delaunay, which gives the same triangles in another order; and
:func:`points_in_ring` in place of matplotlib paths.

Lattice points are kept only if they lie inside the region, outside every
hole ring, and more than ``0.55 h`` from every ring vertex.  Rings are
densified to spacing ``<= h``, so that distance filter also keeps lattice
points clear of the ring edges.
"""

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import spatial

from .. import native
from .. import polygon_ops as ops
from ..geometry import ensure_unique
from ..ops.fem import triangle_areas, vertex_areas
from .polygon import points_in_ring

logger = logging.getLogger("device")

__all__ = [
    "generate_mesh",
    "smooth_mesh",
    "get_edges",
    "get_edge_lengths",
    "boundary_vertices",
    "triangle_areas",
    "vertex_areas",
]


def get_edges(triangles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique undirected edges of a triangulation and a boundary flag
    (an edge is on the boundary if it belongs to exactly one triangle)."""
    edges = np.concatenate([triangles[:, e] for e in [(0, 1), (1, 2), (2, 0)]])
    edges = np.sort(edges, axis=1)
    edges, counts = np.unique(edges, return_counts=True, axis=0)
    return edges, counts == 1


def get_edge_lengths(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Lengths of all unique edges in the triangulation."""
    edges, _ = get_edges(triangles)
    return np.linalg.norm(np.diff(points[edges], axis=1), axis=2).squeeze()


def smooth_mesh(
    points: np.ndarray, triangles: np.ndarray, iterations: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Laplacian smoothing: each interior vertex moves to the mean of its
    neighbors; boundary vertices stay fixed."""
    edges, is_boundary = get_edges(triangles)
    n = points.shape[0]
    boundary = np.unique(edges[is_boundary].ravel())
    points = np.array(points, dtype=float)
    num_neighbors = np.bincount(edges.ravel(), minlength=n)
    for _ in range(iterations):
        new_points = np.zeros_like(points)
        np.add.at(new_points, edges[:, 0], points[edges[:, 1]])
        np.add.at(new_points, edges[:, 1], points[edges[:, 0]])
        new_points /= np.maximum(num_neighbors, 1)[:, None]
        new_points[boundary] = points[boundary]
        points = new_points
    return points, triangles


def boundary_vertices(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Indices of the outer boundary vertices, ordered counterclockwise."""
    edges, is_boundary = get_edges(triangles)
    b_edges = edges[is_boundary]
    if len(b_edges) == 0:
        raise ValueError("Mesh has no boundary edges.")
    neighbors = {}
    for i, j in b_edges:
        neighbors.setdefault(int(i), []).append(int(j))
        neighbors.setdefault(int(j), []).append(int(i))
    loops: List[List[int]] = []
    visited = set()
    for start in neighbors:
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev = None
        node = start
        while True:
            options = [v for v in neighbors[node] if v != prev]
            nxt = None
            for v in options:
                if v == start and len(loop) > 2:
                    nxt = None
                    break
                if v not in visited:
                    nxt = v
                    break
            if nxt is None:
                break
            loop.append(nxt)
            visited.add(nxt)
            prev, node = node, nxt
        loops.append(loop)
    # The outer boundary is the loop enclosing the largest area.
    loop = max(loops, key=lambda lp: abs(ops.signed_area(points[lp])))
    indices = np.array(loop, dtype=np.int64)
    if ops.signed_area(points[indices]) < 0:
        indices = indices[::-1]
    return indices


def _densify_ring(ring: np.ndarray, h: float) -> np.ndarray:
    """Subdivide each ring segment so all segments are <= h.  Exactly
    collinear intermediate vertices are collapsed first so straight edges
    get uniform spacing (and no degenerate Delaunay slivers)."""
    ring = ops.remove_collinear(ops.orient_ccw(ring), tol=1e-9)
    out = []
    n = len(ring)
    for i in range(n):
        a = ring[i]
        b = ring[(i + 1) % n]
        seg = np.linalg.norm(b - a)
        k = max(1, int(np.ceil(seg / h)))
        for t in range(k):
            out.append(a + (b - a) * (t / k))
    return np.array(out)


def _hex_lattice(bbox, h: float) -> np.ndarray:
    """Hexagonal (triangular) lattice covering the bounding box."""
    (xmin, ymin), (xmax, ymax) = bbox
    dy = h * np.sqrt(3) / 2
    rows = int(np.ceil((ymax - ymin) / dy)) + 1
    cols = int(np.ceil((xmax - xmin) / h)) + 2
    ys = ymin + dy * np.arange(rows)
    pts = []
    for r, y in enumerate(ys):
        offset = (h / 2) if (r % 2) else 0.0
        xs = xmin - h + offset + h * np.arange(cols + 1)
        pts.append(np.stack([xs, np.full_like(xs, y)], axis=1))
    return np.concatenate(pts, axis=0)


def _closed(ring: np.ndarray) -> np.ndarray:
    return np.concatenate([ring, ring[:1]], axis=0)


def _in_region(region: np.ndarray, holes: List[np.ndarray], pts: np.ndarray):
    """Inside the closed ``region`` ring and outside every closed hole ring."""
    if len(pts) == 0:
        return np.zeros(0, dtype=bool)
    keep = points_in_ring(region, pts)
    for hole in holes:
        keep &= ~points_in_ring(hole, pts)
    return keep


def _delaunay(pts: np.ndarray) -> np.ndarray:
    """Delaunay triangles of ``pts``: the geometry core's, or SciPy's with
    ``SUPERSCREEN_TPU_NATIVE=0`` or where the core's routine gives up."""
    if native.available():
        tris = native.delaunay(pts)
        if tris is not None:
            return tris
    return spatial.Delaunay(pts).simplices


def _build_once(
    region_ring: np.ndarray,
    hole_rings: List[np.ndarray],
    feature_rings: List[np.ndarray],
    extra_points: Optional[np.ndarray],
    h: float,
    preserve_boundary: bool = False,
    smooth_rounds: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    # 1. Fixed points: boundary ring + feature rings (taken as given when
    # the boundary is preserved and subdivided to segments <= h otherwise)
    # + extra points.
    ring_points = ops.orient_ccw if preserve_boundary else (lambda r: _densify_ring(r, h))
    bring = ring_points(region_ring)
    fixed = [bring] + [ring_points(ring) for ring in hole_rings + feature_rings]
    if extra_points is not None and len(extra_points):
        fixed.append(np.atleast_2d(extra_points))
    fixed_pts = ensure_unique(np.concatenate(fixed, axis=0))
    region = _closed(bring)
    holes = [_closed(ops.orient_ccw(hr)) for hr in hole_rings]

    # 2. Interior lattice, clipped to the region and kept clear of the
    # fixed points.
    lattice = _hex_lattice((bring.min(axis=0), bring.max(axis=0)), h)
    lattice = lattice[_in_region(region, holes, lattice)]
    if len(lattice):
        d, _ = spatial.cKDTree(fixed_pts).query(lattice, k=1)
        lattice = lattice[d > 0.55 * h]

    points = np.concatenate([fixed_pts, lattice], axis=0)
    n_fixed = len(fixed_pts)

    def triangulate(pts):
        simplices = _delaunay(pts)
        keep = _in_region(region, holes, pts[simplices].mean(axis=1))
        # Drop degenerate slivers (collinear boundary runs produce
        # zero-area Delaunay triangles along straight edges).
        areas = np.abs(triangle_areas(pts, simplices))
        keep &= areas > 1e-9 * h * h
        # Quality filter for near-collinear slivers made of fixed
        # (boundary/feature) points only.
        p = pts[simplices]
        emax2 = np.max(np.sum((p - np.roll(p, 1, axis=1)) ** 2, axis=-1), axis=1)
        quality = 2 * areas / np.maximum(emax2, 1e-300)
        all_fixed = np.all(simplices < n_fixed, axis=1)
        keep &= ~(all_fixed & (quality < 0.05))
        return simplices[keep]

    triangles = triangulate(points)
    # 3. Smooth the movable (lattice) points and re-triangulate.
    for _ in range(smooth_rounds):
        smoothed, _ = smooth_mesh(points, triangles, 2)
        smoothed[:n_fixed] = points[:n_fixed]
        points = smoothed
        triangles = triangulate(points)

    # Drop unused points (e.g. lattice points orphaned by filtering).
    used = np.unique(triangles.ravel())
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return points[used], remap[triangles]


def generate_mesh(
    poly_coords: np.ndarray,
    hole_coords: Optional[List[np.ndarray]] = None,
    min_points: Optional[int] = None,
    max_edge_length: Optional[float] = None,
    convex_hull: bool = False,
    boundary: Optional[np.ndarray] = None,
    preserve_boundary: bool = False,
    min_angle: float = 32.5,
    feature_rings: Optional[Sequence[np.ndarray]] = None,
    extra_points: Optional[np.ndarray] = None,
    smooth_rounds: int = 2,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generates a boundary-conforming Delaunay mesh for a polygonal region.

    Args:
        poly_coords: Shape ``(n, 2)`` outer polygon coordinates.
        hole_coords: Hole boundary rings; triangles inside them are dropped.
        min_points: Minimum number of vertices in the resulting mesh.
        max_edge_length: Maximum length of (interior, if
            ``preserve_boundary``) mesh edges.
        convex_hull: Mesh the whole convex hull of ``poly_coords``, which
            becomes a feature ring.
        boundary: An explicit outer boundary ring; ``poly_coords`` becomes
            a feature ring the mesh conforms to.  Not with ``convex_hull``.
        preserve_boundary: Do not add vertices to the boundary (mandatory
            for films with transport terminals).
        min_angle: Accepted, as by the JAX package, for the API of the
            reference's Triangle mesher, and not used: the lattice and the
            smoothing set the mesh quality.
        feature_rings: Polygon outlines the mesh must conform to (their
            interiors are meshed).
        extra_points: Isolated vertices to include, kept as fixed points.
        smooth_rounds: Rounds of (smooth + re-triangulate) per build.
        kwargs: Accepted and not used, as by the JAX package.

    Returns:
        ``(points, triangles)``: vertex coordinates and triangle indices.
    """
    del min_angle, kwargs  # API-parity arguments; unused by this generator.
    poly_coords = ensure_unique(np.asarray(poly_coords, dtype=float))
    hole_rings = [
        ops.orient_ccw(ensure_unique(np.asarray(c, dtype=float)))
        for c in (hole_coords or [])
    ]
    feat_rings = [
        ops.orient_ccw(ensure_unique(np.asarray(c, dtype=float)))
        for c in (feature_rings or [])
    ]
    if convex_hull:
        if boundary is not None:
            raise ValueError(
                "Cannot have both boundary is not None and convex_hull = True."
            )
        region_ring = poly_coords[spatial.ConvexHull(poly_coords).vertices]
        feat_rings = [poly_coords] + feat_rings
    elif boundary is not None:
        region_ring = ops.orient_ccw(ensure_unique(np.asarray(boundary, dtype=float)))
        feat_rings = [poly_coords] + feat_rings
    else:
        region_ring = ops.orient_ccw(poly_coords)
    seg_lengths = np.linalg.norm(np.diff(_closed(region_ring), axis=0), axis=1)
    area = ops.polygon_area(region_ring) - sum(
        ops.polygon_area(hr) for hr in hole_rings
    )
    h = float(np.median(seg_lengths))
    if max_edge_length is not None and max_edge_length > 0:
        h = min(h, 0.95 * max_edge_length)
    else:
        max_edge_length = np.inf
    min_points = min_points or 0
    if min_points:
        # Hexagonal lattice density ~ 2 / (sqrt(3) h^2) points per unit area.
        h = min(h, np.sqrt(2 * area / (np.sqrt(3) * min_points)))

    for iteration in range(40):
        points, triangles = _build_once(
            region_ring, hole_rings, feat_rings, extra_points, h, preserve_boundary,
            smooth_rounds=smooth_rounds,
        )
        edges, is_boundary = get_edges(triangles)
        if preserve_boundary and not is_boundary.all():
            edges = edges[~is_boundary]
        max_length = float(
            np.linalg.norm(np.diff(points[edges], axis=1), axis=2).max()
        )
        logger.debug(
            "Mesh build %d: %d points, max edge %.3e (target %.3e).",
            iteration,
            len(points),
            max_length,
            max_edge_length,
        )
        if len(points) >= min_points and max_length <= max_edge_length:
            return points, triangles
        shrink = 0.8
        if max_length > max_edge_length:
            shrink = min(shrink, 0.95 * max_edge_length / max_length)
        if len(points) < min_points:
            shrink = min(shrink, np.sqrt(len(points) / min_points) * 0.95)
        h *= max(shrink, 0.25)
    raise RuntimeError(
        "Mesh generation failed to satisfy min_points/max_edge_length "
        "constraints after 40 refinement iterations."
    )

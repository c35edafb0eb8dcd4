"""Plain NumPy geometry and finite-element operators of one film's mesh.

Everything here is float64 and follows the method's published definitions:
lumped vertex areas (a third of the adjacent triangle areas), the
half-cotangent Laplace-Beltrami operator divided by the vertex areas, and
vertex gradients as angle-weighted means of the adjacent triangles'
gradients (each triangle weighted by its interior angle at its first
vertex).  Points on a polygon's outline are decided by the crossing-number
arithmetic of matplotlib's ``point_in_path`` (a frozen copy of that plain
routine), so that mesh vertices on a hole's outline fall on the same side
as in any program that follows matplotlib.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


def circle(radius: float, points: int) -> np.ndarray:
    """``points`` counterclockwise vertices of a circle about the origin."""
    theta = np.linspace(0, 2 * np.pi, points, endpoint=False)
    return np.column_stack([radius * np.cos(theta), radius * np.sin(theta)])


def closed_ccw(points) -> np.ndarray:
    """The ring oriented counterclockwise and closed (last vertex = first)."""
    ring = np.asarray(points, dtype=float)
    if len(ring) > 1 and np.allclose(ring[0], ring[-1]):
        ring = ring[:-1]
    x, y = ring[:, 0], ring[:, 1]
    if np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) < 0:
        ring = ring[::-1]
    return np.concatenate([ring, ring[:1]], axis=0)


def points_in_ring(ring: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Crossing-number test of ``points`` against the closed ``ring`` with
    matplotlib's arithmetic: per edge ``v0 -> v1`` a point toggles when
    ``(y1 >= ty) != (y0 >= ty)`` and
    ``((y1 - ty) (x0 - x1) >= (x1 - tx) (y0 - y1)) == (y1 >= ty)``."""
    ring = np.asarray(ring, dtype=float)
    tx, ty = points[:, 0], points[:, 1]
    verts = np.concatenate([ring[:-1], ring[:1]], axis=0)
    inside = np.zeros(len(points), dtype=bool)
    yflag0 = verts[0, 1] >= ty
    for (x0, y0), (x1, y1) in zip(verts[:-1], verts[1:]):
        yflag1 = y1 >= ty
        inside ^= (yflag0 != yflag1) & (
            ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1
        )
        yflag0 = yflag1
    return inside


def triangle_areas(sites: np.ndarray, elements: np.ndarray) -> np.ndarray:
    """Signed triangle areas (positive for counterclockwise vertices)."""
    p = sites[elements]
    return 0.5 * (
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
    )


def boundary_indices(elements: np.ndarray) -> np.ndarray:
    """Vertices of the edges that belong to one triangle only."""
    edges = np.sort(np.concatenate([elements[:, [0, 1]], elements[:, [1, 2]], elements[:, [2, 0]]]), axis=1)
    edges, counts = np.unique(edges, return_counts=True, axis=0)
    return np.unique(edges[counts == 1])


def _angles(sites: np.ndarray, elements: np.ndarray) -> np.ndarray:
    """Interior angle of each triangle at each of its vertices, ``(m, 3)``."""
    p = sites[elements]
    out = np.empty(elements.shape)
    for k in range(3):
        a = p[:, (k + 1) % 3] - p[:, k]
        b = p[:, (k + 2) % 3] - p[:, k]
        cos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        out[:, k] = np.arccos(np.clip(cos, -1.0, 1.0))
    return out


@dataclass
class Triplets:
    """A sparse ``(n, n)`` operator as (rows, cols, vals); duplicates sum."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray


def laplacian(sites: np.ndarray, elements: np.ndarray, areas: np.ndarray) -> Triplets:
    """``diag(1/areas) (W - diag(W 1))`` with the half-cotangent weights
    ``W_ij = (cot a + cot b) / 2`` of the angles opposite edge ``ij``."""
    ang = _angles(sites, elements)
    rows, cols, vals = [], [], []
    for k in range(3):
        i, j = elements[:, (k + 1) % 3], elements[:, (k + 2) % 3]
        w = 0.5 / np.tan(ang[:, k])
        rows += [i, j]
        cols += [j, i]
        vals += [w, w]
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    n = len(sites)
    row_sums = np.bincount(rows, weights=vals, minlength=n)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, -row_sums])
    return Triplets(rows, cols, vals / areas[rows])


def vertex_gradients(sites: np.ndarray, elements: np.ndarray, tri_areas: np.ndarray) -> Tuple[Triplets, Triplets]:
    """``(gx, gy)``: the gradient of a vertex field at each vertex, the mean
    of its triangles' (constant) gradients, each triangle weighted by its
    interior angle at its first vertex."""
    p = sites[elements]
    # Triangle gradient of the hat function of local vertex l: the opposite
    # edge rotated by -90 degrees over twice the area.
    edges = np.roll(p, 2, axis=1) - np.roll(p, 1, axis=1)
    tgx = edges[:, :, 1] / (2 * tri_areas[:, None])
    tgy = -edges[:, :, 0] / (2 * tri_areas[:, None])
    weight = _angles(sites, elements)[:, 0]
    total = np.zeros(len(sites))
    for k in range(3):
        np.add.at(total, elements[:, k], weight)
    rows, cols, vx, vy = [], [], [], []
    for k in range(3):
        i = elements[:, k]
        share = weight / total[i]
        for l in range(3):
            rows.append(i)
            cols.append(elements[:, l])
            vx.append(share * tgx[:, l])
            vy.append(share * tgy[:, l])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return Triplets(rows, cols, np.concatenate(vx)), Triplets(rows, cols, np.concatenate(vy))


@dataclass
class FilmMesh:
    """One film's mesh and what the method derives from it (host, float64).

    ``interior`` are the sites inside the film outline, off the mesh
    boundary and outside every hole; ``holes`` maps each hole to the sites
    inside its outline."""

    name: str
    sites: np.ndarray
    areas: np.ndarray
    lap: Triplets
    gx: Triplets
    gy: Triplets
    interior: np.ndarray
    holes: Dict[str, np.ndarray]
    Lambda: float
    z0: float


def film_mesh(name, sites, elements, outline, holes, Lambda, z0) -> FilmMesh:
    """The :class:`FilmMesh` of a film whose mesh is ``(sites, elements)``,
    whose outline is ``outline`` and whose holes are ``{name: outline}``."""
    sites = np.asarray(sites, dtype=float)
    elements = np.asarray(elements, dtype=np.int64)
    tri = triangle_areas(sites, elements)
    areas = np.zeros(len(sites))
    for k in range(3):
        np.add.at(areas, elements[:, k], tri / 3)
    hole_sites = {h: np.flatnonzero(points_in_ring(closed_ccw(ring), sites)) for h, ring in holes.items()}
    inside = np.flatnonzero(points_in_ring(closed_ccw(outline), sites))
    interior = np.setdiff1d(inside, boundary_indices(elements))
    if hole_sites:
        interior = np.setdiff1d(interior, np.concatenate(list(hole_sites.values())))
    gx, gy = vertex_gradients(sites, elements, tri)
    return FilmMesh(
        name=name, sites=sites, areas=areas, lap=laplacian(sites, elements, areas), gx=gx, gy=gy,
        interior=interior, holes=hole_sites, Lambda=float(Lambda), z0=float(z0),
    )

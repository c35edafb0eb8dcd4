"""Host-side geometry helpers.

API parity with the reference ``superscreen/geometry.py`` (circle, ellipse,
box, rotate, translate, path_vectors, close_curve, ensure_unique), implemented
with plain NumPy.  These run on the host as part of device construction and
meshing; nothing here is on the solver hot path.
"""

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "unit_vector",
    "path_vectors",
    "rotation_matrix",
    "rotate",
    "translate",
    "ellipse",
    "circle",
    "box",
    "close_curve",
    "ensure_unique",
]


def _as_xy(coords: np.ndarray) -> np.ndarray:
    coords = np.asarray(coords)
    assert coords.ndim == 2 and coords.shape[1] == 2
    return coords


def unit_vector(vector: np.ndarray) -> np.ndarray:
    """Normalizes ``vector`` along its last axis."""
    return vector / np.linalg.norm(vector, axis=-1, keepdims=True)


def path_vectors(path: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Edge lengths and outward unit normals for a path.

    For each edge ``dr`` of the path, the normal is ``dr x z`` normalized
    (reference: ``superscreen/geometry.py:12-29``).

    Args:
        path: Shape ``(n, 2)`` array of coordinates representing a
            continuous path.

    Returns:
        A tuple ``(edge_lengths, unit_normals)`` with shapes ``(n - 1,)``
        and ``(n - 1, 2)``.
    """
    edges = np.diff(path, axis=0)
    edge_lengths = np.linalg.norm(edges, axis=1)
    # (dx, dy, 0) x (0, 0, 1) = (dy, -dx, 0): rotate each edge -90 degrees.
    unit_normals = edges[:, ::-1] * np.array([1.0, -1.0])
    unit_normals /= edge_lengths[:, np.newaxis]
    return edge_lengths, unit_normals


def rotation_matrix(angle_radians: float) -> np.ndarray:
    """Returns a 2D counterclockwise rotation matrix."""
    c, s = np.cos(angle_radians), np.sin(angle_radians)
    return np.array([[c, -s], [s, c]])


def rotate(coords: np.ndarray, angle_degrees: float) -> np.ndarray:
    """Rotates ``(n, 2)`` coordinates counterclockwise about the origin."""
    return _as_xy(coords) @ rotation_matrix(np.radians(angle_degrees)).T


def translate(coords: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Translates ``(n, 2)`` coordinates by ``(dx, dy)``."""
    return _as_xy(coords) + np.array([[dx, dy]])


def ellipse(
    a: float,
    b: float,
    points: int = 100,
    center: Tuple[float, float] = (0, 0),
    angle: float = 0,
) -> np.ndarray:
    """Counterclockwise coordinates of an ellipse with semi-axes ``a, b``.

    Matches the reference's operation order exactly (translate to ``center``,
    then rotate about the origin when ``angle`` is nonzero), so digitized
    layouts built against the reference mesh identically.
    """
    theta = np.linspace(0, 2 * np.pi, points, endpoint=False)
    coords = np.column_stack([a * np.cos(theta), b * np.sin(theta)])
    coords += np.asarray(center)[np.newaxis]
    return rotate(coords, angle) if angle else coords


def circle(
    radius: float, points: int = 100, center: Tuple[float, float] = (0, 0)
) -> np.ndarray:
    """Counterclockwise coordinates of a circle."""
    return ellipse(radius, radius, points=points, center=center, angle=0)


def box(
    width: float,
    height: Optional[float] = None,
    points: int = 101,
    center: Tuple[float, float] = (0, 0),
    angle: float = 0,
) -> np.ndarray:
    """Counterclockwise coordinates of a rectangle with the given width and
    height (reference: ``superscreen/geometry.py:128-179``).

    The walk starts at the bottom-right corner and distributes ``points``
    over the perimeter proportionally to edge length; shared corners are
    emitted twice (deduplicated downstream by :func:`ensure_unique`).
    """
    width = abs(width)
    height = width if height is None else abs(height)
    x_points = round(points * width / (2 * (width + height)))
    y_points = round(points * height / (2 * (width + height)))
    w, h = width / 2, height / 2
    corners = np.array([[w, -h], [w, h], [-w, h], [-w, -h], [w, -h]])
    per_edge = (y_points, x_points, y_points, x_points)
    coords = np.concatenate(
        [
            np.linspace(start, stop, n)
            for start, stop, n in zip(corners[:-1], corners[1:], per_edge)
        ]
    )
    coords += np.asarray(center)[np.newaxis]
    return rotate(coords, angle) if angle else coords


def close_curve(points: np.ndarray) -> np.ndarray:
    """Appends the first point to the end of the curve if it is not closed."""
    points = np.asarray(points)
    if np.allclose(points[0], points[-1]):
        return points
    return np.concatenate([points, points[:1]], axis=0)


def ensure_unique(coords: np.ndarray) -> np.ndarray:
    """Removes duplicate coordinates, preserving order of first appearance."""
    coords = np.asarray(coords)
    _, first_seen = np.unique(coords, return_index=True, axis=0)
    return coords[np.sort(first_seen)]

"""Pure-NumPy computational-geometry kernel.

A self-contained replacement for the GEOS (shapely) dependency of the
reference implementation (used in ``superscreen/device/polygon.py`` for
polygon booleans, buffering, and resampling, and in
``superscreen/device/utils.py`` for boundary polygonization).  Scope is
deliberately limited to what a thin-film device layout needs:

* simple (non-self-intersecting) polygons with CCW orientation,
* boolean operations (union / intersection / difference) via the
  Greiner-Hormann algorithm with deterministic perturbation for degeneracies,
* polygon offsetting ("buffer") with mitre / round / bevel joins,
* uniform boundary resampling,
* point-in-polygon tests, areas, centroids, and boundary distances.

Everything here is host-side preprocessing; none of it runs under jit.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = [
    "signed_area",
    "polygon_area",
    "centroid",
    "orient_ccw",
    "is_simple_polygon",
    "points_in_polygon",
    "remove_collinear",
    "boolean_op",
    "boolean_pieces",
    "buffer_polygon",
    "resample_polygon",
    "polygon_boundary_distance",
    "PolygonOpError",
]


class PolygonOpError(ValueError):
    """Raised when a polygon operation does not yield a valid simple polygon."""


# ---------------------------------------------------------------------------
# Basic predicates and measures
# ---------------------------------------------------------------------------


def _open_ring(points: np.ndarray) -> np.ndarray:
    """Returns the polygon vertices without a repeated closing point."""
    points = np.asarray(points, dtype=float)
    if points.ndim != 2 or points.shape[1] != 2:
        raise PolygonOpError(f"Expected shape (n, 2), got {points.shape}.")
    if len(points) > 1 and np.allclose(points[0], points[-1]):
        points = points[:-1]
    # Drop consecutive duplicates.
    keep = np.ones(len(points), dtype=bool)
    d = np.linalg.norm(np.diff(points, axis=0), axis=1)
    keep[1:] = d > 0
    return points[keep]


def signed_area(points: np.ndarray) -> float:
    """Shoelace signed area (positive for CCW orientation)."""
    p = _open_ring(points)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_area(points: np.ndarray) -> float:
    """Absolute polygon area."""
    return abs(signed_area(points))


def centroid(points: np.ndarray) -> np.ndarray:
    """Polygon centroid (center of mass of the enclosed region)."""
    p = _open_ring(points)
    x, y = p[:, 0], p[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = 0.5 * np.sum(cross)
    if np.abs(a) < 1e-300:
        return p.mean(axis=0)
    cx = np.sum((x + xn) * cross) / (6 * a)
    cy = np.sum((y + yn) * cross) / (6 * a)
    return np.array([cx, cy])


def orient_ccw(points: np.ndarray) -> np.ndarray:
    """Returns the ring oriented counterclockwise (open, no closing point)."""
    p = _open_ring(points)
    if signed_area(p) < 0:
        p = p[::-1]
    return p


def _seg_intersect(p0, p1, q0, q1, eps: float = 0.0):
    """Proper intersection of segments ``p0p1`` and ``q0q1``.

    Returns ``(t, u, point)`` with parameters in (0, 1) strictly, or None.
    ``eps`` expands the exclusion window near endpoints: parameters within
    ``eps`` of 0 or 1 are treated as degenerate and reported via ValueError.
    """
    r = p1 - p0
    s = q1 - q0
    denom = r[0] * s[1] - r[1] * s[0]
    qp = q0 - p0
    if denom == 0:
        return None
    t = (qp[0] * s[1] - qp[1] * s[0]) / denom
    u = (qp[0] * r[1] - qp[1] * r[0]) / denom
    if eps:
        if t < -eps or t > 1 + eps or u < -eps or u > 1 + eps:
            return None
        if t < eps or t > 1 - eps or u < eps or u > 1 - eps:
            # Intersection at (or within eps of) a segment endpoint:
            # degenerate configuration, caller should perturb and retry.
            raise _Degenerate()
    elif t <= 0 or t >= 1 or u <= 0 or u >= 1:
        return None
    return t, u, p0 + t * r


class _Degenerate(Exception):
    pass


def is_simple_polygon(points: np.ndarray) -> bool:
    """True if the ring has no self-intersections and nonzero area.

    Self-intersection means a strict interior crossing of two non-adjacent
    edges (the same predicate as :func:`_seg_intersect` with ``eps=0``),
    computed vectorized over all edge pairs in blocks so the check stays
    cheap for rings with thousands of vertices.
    """
    p = _open_ring(points)
    n = len(p)
    if n < 3 or polygon_area(p) == 0:
        return False
    x0, y0 = p[:, 0], p[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    rx, ry = x1 - x0, y1 - y0
    idx = np.arange(n)
    block = max(1, min(n, 4_000_000 // max(n, 1)))
    for start in range(0, n, block):
        stop = min(start + block, n)
        bi = slice(start, stop)
        # All 2D (b, n) arrays; strict interior crossing without divisions:
        # 0 < t < 1  <=>  t_num*denom > 0 and (t_num - denom)*denom < 0.
        qx = x0[None, :] - x0[bi, None]
        qy = y0[None, :] - y0[bi, None]
        denom = rx[bi, None] * ry[None, :] - ry[bi, None] * rx[None, :]
        t_num = qx * ry[None, :] - qy * rx[None, :]
        u_num = qx * ry[bi, None] - qy * rx[bi, None]
        hit = (
            (t_num * denom > 0)
            & ((t_num - denom) * denom < 0)
            & (u_num * denom > 0)
            & ((u_num - denom) * denom < 0)
        )
        # Mask self and adjacent edge pairs (ring-adjacency wraps around).
        sep = np.abs(idx[bi, None] - idx[None, :])
        hit &= (sep > 1) & (sep < n - 1)
        if hit.any():
            return False
    # Repeated (non-consecutive) vertices also make the ring non-simple
    # (e.g. a bowtie passing through the same point twice).
    uniq = np.unique(np.round(p, 12), axis=0)
    if len(uniq) != n:
        return False
    return True


def points_in_polygon(
    poly: np.ndarray, query: np.ndarray, include_boundary: bool = False
) -> np.ndarray:
    """Even-odd-rule point-in-polygon test.

    Args:
        poly: Shape ``(n, 2)`` polygon vertices.
        query: Shape ``(m, 2)`` query points.
        include_boundary: Count points exactly on an edge as inside.

    Returns:
        Boolean array of shape ``(m,)``.
    """
    p = _open_ring(poly)
    q = np.atleast_2d(np.asarray(query, dtype=float))
    x, y = q[:, 0], q[:, 1]
    x0, y0 = p[:, 0], p[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(len(q), dtype=bool)
    for xa, ya, xb, yb in zip(x0, y0, x1, y1):
        cond = (ya > y) != (yb > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (xb - xa) * (y - ya) / (yb - ya) + xa
        crossing = cond & (x < xint)
        inside ^= crossing
    if include_boundary:
        onb = _points_on_boundary(p, q)
        inside = inside | onb
    return inside


def _points_on_boundary(
    poly: np.ndarray, query: np.ndarray, tol: float = 1e-12
) -> np.ndarray:
    p = _open_ring(poly)
    a = p
    b = np.roll(p, -1, axis=0)
    ab = b - a  # (n, 2)
    ab2 = np.sum(ab**2, axis=1)  # (n,)
    aq = query[:, None, :] - a[None, :, :]  # (m, n, 2)
    t = np.einsum("mnk, nk -> mn", aq, ab) / np.maximum(ab2, 1e-300)
    t = np.clip(t, 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    d = np.linalg.norm(query[:, None, :] - proj, axis=-1)
    scale = max(np.ptp(p[:, 0]), np.ptp(p[:, 1]), 1.0)
    return np.min(d, axis=1) <= tol * scale


def remove_collinear(points: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """Removes vertices lying (within tol, relative) on the segment between
    their neighbors.  Near-duplicate vertices (within ``1e-7`` of the polygon
    scale, e.g. from the boolean-op perturbation ladder) are merged first so
    corners flanked by a micro-segment are not misdetected as collinear."""
    p = _open_ring(points)
    scale = max(np.ptp(p[:, 0]), np.ptp(p[:, 1]), 1e-300)
    for _ in range(8):
        n = len(p)
        if n <= 3:
            return p
        # Merge near-duplicate consecutive vertices.
        d = np.linalg.norm(p - np.roll(p, -1, axis=0), axis=1)
        keep_dup = d > 1e-7 * scale
        if not keep_dup.all():
            p = p[keep_dup]
            continue
        a = np.roll(p, 1, axis=0)
        c = np.roll(p, -1, axis=0)
        cross = (p[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
            p[:, 1] - a[:, 1]
        ) * (c[:, 0] - a[:, 0])
        keep = np.abs(cross) > tol * scale * scale
        if keep.all() or keep.sum() < 3:
            return p
        p = p[keep]
    return p


# ---------------------------------------------------------------------------
# Greiner-Hormann boolean operations
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = (
        "xy",
        "next",
        "prev",
        "intersect",
        "neighbor",
        "alpha",
        "entry",
        "processed",
    )

    def __init__(self, xy, alpha=0.0, intersect=False):
        self.xy = np.asarray(xy, dtype=float)
        self.next = None
        self.prev = None
        self.intersect = intersect
        self.neighbor = None
        self.alpha = alpha
        self.entry = False
        self.processed = False


def _build_ring(points: np.ndarray) -> _Node:
    nodes = [_Node(xy) for xy in points]
    n = len(nodes)
    for i, node in enumerate(nodes):
        node.next = nodes[(i + 1) % n]
        node.prev = nodes[i - 1]
    return nodes[0]


def _ring_nodes(first: _Node, original_only: bool = False) -> List[_Node]:
    out = []
    node = first
    while True:
        if not original_only or not node.intersect:
            out.append(node)
        node = node.next
        if node is first:
            break
    return out


def _insert_between(new: _Node, start: _Node, end: _Node) -> None:
    """Insert an intersection node between start and end, ordered by alpha."""
    node = start
    nxt = start.next
    while nxt is not end and nxt.intersect and nxt.alpha < new.alpha:
        node = nxt
        nxt = node.next
    new.next = nxt
    new.prev = node
    node.next = new
    nxt.prev = new


def _original_next(node: _Node) -> _Node:
    nxt = node.next
    while nxt.intersect:
        nxt = nxt.next
    return nxt


def _candidate_pairs(s0, s1, c0, c1, eps: float) -> np.ndarray:
    """Indices ``(i, j)`` of subject/clip segment pairs whose infinite-line
    parameters fall inside the (eps-expanded) unit windows — exactly the
    pairs for which :func:`_seg_intersect` returns a hit or raises
    :class:`_Degenerate`. All-pairs numpy prefilter so the boolean ops stay
    fast for rings with thousands of vertices."""
    r = s1 - s0  # (k, 2)
    s = c1 - c0  # (l, 2)
    k, l = len(s0), len(c0)
    lo, hi = (-eps, 1 + eps) if eps else (0.0, 1.0)
    block = max(1, min(k, 4_000_000 // max(l, 1)))
    out = []
    for start in range(0, k, block):
        bi = slice(start, min(start + block, k))
        denom = r[bi, None, 0] * s[None, :, 1] - r[bi, None, 1] * s[None, :, 0]
        qx = c0[None, :, 0] - s0[bi, None, 0]
        qy = c0[None, :, 1] - s0[bi, None, 1]
        t_num = qx * s[None, :, 1] - qy * s[None, :, 0]
        u_num = qx * r[bi, None, 1] - qy * r[bi, None, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = t_num / denom
            u = u_num / denom
        ok = denom != 0
        if eps:
            ok &= (t >= lo) & (t <= hi) & (u >= lo) & (u <= hi)
        else:
            ok &= (t > lo) & (t < hi) & (u > lo) & (u < hi)
        hits = np.argwhere(ok)
        if len(hits):
            hits[:, 0] += start
            out.append(hits)
    if not out:
        return np.empty((0, 2), dtype=np.int64)
    return np.concatenate(out, axis=0)


def _find_intersections(subj_first: _Node, clip_first: _Node, eps: float) -> int:
    count = 0
    subj_orig = _ring_nodes(subj_first, original_only=True)
    clip_orig = _ring_nodes(clip_first, original_only=True)
    subj_ends = [_original_next(s) for s in subj_orig]
    clip_ends = [_original_next(c) for c in clip_orig]
    pairs = _candidate_pairs(
        np.array([s.xy for s in subj_orig]),
        np.array([s.xy for s in subj_ends]),
        np.array([c.xy for c in clip_orig]),
        np.array([c.xy for c in clip_ends]),
        eps,
    )
    for i, j in pairs:  # row-major: same order as the original nested loop
        s, s_end = subj_orig[i], subj_ends[i]
        c, c_end = clip_orig[j], clip_ends[j]
        hit = _seg_intersect(s.xy, s_end.xy, c.xy, c_end.xy, eps=eps)
        if hit is None:
            continue
        t, u, point = hit
        ns = _Node(point, alpha=t, intersect=True)
        nc = _Node(point, alpha=u, intersect=True)
        ns.neighbor = nc
        nc.neighbor = ns
        _insert_between(ns, s, s_end)
        _insert_between(nc, c, c_end)
        count += 1
    return count


def _mark_entries(first: _Node, other_poly: np.ndarray, invert: bool) -> None:
    start_inside = bool(points_in_polygon(other_poly, first.xy[None])[0])
    status = not start_inside  # next crossing is an entry if we start outside
    if invert:
        status = not status
    node = first
    while True:
        if node.intersect:
            node.entry = status
            status = not status
        node = node.next
        if node is first:
            break


def _traverse(subj_first: _Node) -> List[np.ndarray]:
    polygons = []
    while True:
        current = None
        node = subj_first
        while True:
            if node.intersect and not node.processed:
                current = node
                break
            node = node.next
            if node is subj_first:
                break
        if current is None:
            break
        result = [current.xy]
        start = current
        node = current
        while True:
            node.processed = True
            if node.neighbor is not None:
                node.neighbor.processed = True
            if node.entry:
                while True:
                    node = node.next
                    result.append(node.xy)
                    if node.intersect:
                        break
            else:
                while True:
                    node = node.prev
                    result.append(node.xy)
                    if node.intersect:
                        break
            node.processed = True
            node = node.neighbor
            if node is start or node.neighbor is start:
                break
        polygons.append(np.array(result))
    return polygons


def _boolean_once(
    subject: np.ndarray, clip: np.ndarray, op: str, eps: float
) -> List[np.ndarray]:
    subj_first = _build_ring(subject)
    clip_first = _build_ring(clip)
    n_int = _find_intersections(subj_first, clip_first, eps)
    if n_int == 0:
        s_in_c = bool(points_in_polygon(clip, subject[:1])[0])
        c_in_s = bool(points_in_polygon(subject, clip[:1])[0])
        if op == "intersection":
            if s_in_c:
                return [subject]
            if c_in_s:
                return [clip]
            return []
        if op == "union":
            if s_in_c:
                return [clip]
            if c_in_s:
                return [subject]
            raise PolygonOpError(
                "The union of two disjoint polygons is not a simple polygon."
            )
        # difference
        if c_in_s:
            raise PolygonOpError(
                "The difference contains a hole; the result is not "
                "simply connected."
            )
        if s_in_c:
            return []
        return [subject]
    # Entry/exit classification, with op-dependent inversion:
    #   intersection: no inversion
    #   union: invert both
    #   difference (subject - clip): invert subject's flags only
    invert_subj = op in ("union", "difference")
    invert_clip = op in ("union",)
    _mark_entries(subj_first, clip, invert_subj)
    _mark_entries(clip_first, subject, invert_clip)
    return _traverse(subj_first)


def boolean_op(subject: np.ndarray, clip: np.ndarray, op: str) -> np.ndarray:
    """Boolean operation between two simple polygons.

    Args:
        subject: Shape ``(n, 2)`` vertices of the subject polygon.
        clip: Shape ``(m, 2)`` vertices of the clip polygon.
        op: One of ``"union"``, ``"intersection"``, ``"difference"``.

    Returns:
        The vertices of the resulting polygon (CCW, open ring).

    Raises:
        PolygonOpError: If the result is empty, multiple polygons, or not
            simply connected.  Use :func:`boolean_pieces` when a
            multi-piece result (e.g. a difference that splits the subject)
            is acceptable.
    """
    results = boolean_pieces(subject, clip, op)
    if len(results) > 1:
        raise PolygonOpError(
            f"The {op} of the two polygons is not a single polygon "
            f"(got {len(results)} parts)."
        )
    return results[0]


def boolean_pieces(
    subject: np.ndarray, clip: np.ndarray, op: str
) -> List[np.ndarray]:
    """Boolean operation returning EVERY resulting piece.

    Like :func:`boolean_op` but multi-polygon aware: a difference that
    splits the subject (or a union/intersection producing several
    components) returns one CCW open ring per piece instead of raising.
    This is the engine's analog of the reference's shapely MultiPolygon
    results (reference ``superscreen/device/polygon.py:302-435``, which
    raises on multi-part results just like :func:`boolean_op`).

    Args:
        subject: Shape ``(n, 2)`` vertices of the subject polygon.
        clip: Shape ``(m, 2)`` vertices of the clip polygon.
        op: One of ``"union"``, ``"intersection"``, ``"difference"``.

    Returns:
        A non-empty list of ``(k, 2)`` piece vertices (CCW, open rings),
        largest piece first.

    Raises:
        PolygonOpError: If the result is empty, contains a hole (a
            difference with the clip strictly inside the subject -- not
            representable as simple rings), the union is disjoint, or the
            inputs are not simple polygons.
    """
    if op == "symmetric_difference":
        raise PolygonOpError(
            "The symmetric difference of two overlapping polygons is not a "
            "simple polygon."
        )
    if op not in ("union", "intersection", "difference"):
        raise PolygonOpError(f"Unknown operation: {op!r}.")
    subject = orient_ccw(np.asarray(subject, dtype=float))
    clip = orient_ccw(np.asarray(clip, dtype=float))
    # Garbage-in guard: a self-intersecting input produces a silently wrong
    # result (the Greiner-Hormann traversal assumes simple rings), so refuse.
    for ring_name, ring in (("subject", subject), ("clip", clip)):
        if not is_simple_polygon(ring):
            raise PolygonOpError(
                f"The {ring_name} polygon is not a simple polygon "
                "(it is self-intersecting or degenerate)."
            )
    scale = max(
        np.ptp(subject[:, 0]),
        np.ptp(subject[:, 1]),
        np.ptp(clip[:, 0]),
        np.ptp(clip[:, 1]),
        1e-300,
    )
    # Deterministic perturbation ladder: vertex-on-edge degeneracies are
    # escaped by nudging the clip polygon by a tiny, growing offset.  The
    # offset points away from the subject's centroid so shared/collinear
    # boundary segments (e.g. a notch cut flush with the film edge) become
    # proper crossings rather than silently losing the overlap.
    shift = centroid(clip) - centroid(subject)
    norm = np.linalg.norm(shift)
    if norm < 1e-12 * scale:
        shift = np.array([1.0, np.sqrt(2.0)])
        norm = np.linalg.norm(shift)
    shift = shift / norm
    if op == "union":
        # Touching polygons should merge: push the clip toward the subject.
        shift = -shift
    last_err: Optional[Exception] = None
    for attempt in range(6):
        # Always perturb (never zero): polygons sharing collinear boundary
        # segments would otherwise be misclassified as containment.  The
        # direction is rotated a bit more each attempt so a shift that is
        # axis-aligned with a shared corner's edges cannot stay degenerate.
        delta = scale * 1e-11 * 10.0**attempt
        theta = 0.07 + 0.13 * attempt
        c, s = np.cos(theta), np.sin(theta)
        rshift = np.array(
            [c * shift[0] - s * shift[1], s * shift[0] + c * shift[1]]
        )
        try:
            results = _boolean_once(subject, clip + delta * rshift, op, eps=1e-9)
        except _Degenerate as err:
            last_err = err
            continue
        results = [r for r in results if polygon_area(r) > (1e-12 * scale) ** 2]
        if not results:
            raise PolygonOpError(f"The {op} of the two polygons is empty.")
        if len(results) > 1:
            # Tiny sliver artifacts can appear from perturbation; drop them.
            areas = [polygon_area(r) for r in results]
            amax = max(areas)
            results = [r for r, a in zip(results, areas) if a > 1e-9 * amax]
        out = [orient_ccw(r) for r in results if len(r) >= 3]
        if not out:
            raise PolygonOpError(f"The {op} of the two polygons is degenerate.")
        out.sort(key=polygon_area, reverse=True)
        return out
    raise PolygonOpError(
        f"Polygon {op} failed due to persistent degeneracies."
    ) from last_err


# ---------------------------------------------------------------------------
# Buffering (offsetting)
# ---------------------------------------------------------------------------


def _remove_loops(points: np.ndarray, outward: bool) -> np.ndarray:
    """Iteratively removes self-intersection loops from a ring by splicing
    at intersection points, keeping the dominant (largest-area) loop."""
    p = _open_ring(points)
    for _ in range(64):
        n = len(p)
        found = None
        for i in range(n):
            a0, a1 = p[i], p[(i + 1) % n]
            for j in range(i + 2, n):
                if i == 0 and j == n - 1:
                    continue
                b0, b1 = p[j], p[(j + 1) % n]
                hit = _seg_intersect(a0, a1, b0, b1)
                if hit is not None:
                    found = (i, j, hit[2])
                    break
            if found:
                break
        if not found:
            return p
        i, j, x = found
        # Two candidate rings: splice out (i+1..j) or keep only it.
        ring_a = np.concatenate([p[: i + 1], [x], p[j + 1 :]], axis=0)
        ring_b = np.concatenate([[x], p[i + 1 : j + 1]], axis=0)
        # Keep the ring with the larger area (outward offset) -- loops are
        # always parasitic for outward buffers of simple polygons.
        pa, pb = polygon_area(ring_a), polygon_area(ring_b)
        p = _open_ring(ring_a if pa >= pb else ring_b)
        if len(p) < 3:
            raise PolygonOpError("Buffer operation collapsed the polygon.")
    raise PolygonOpError("Too many self-intersections in buffered polygon.")


def buffer_polygon(
    points: np.ndarray,
    distance: float,
    join_style: str = "mitre",
    mitre_limit: float = 5.0,
    quad_segs: int = 8,
) -> np.ndarray:
    """Offsets a simple polygon outward (``distance > 0``) or inward
    (``distance < 0``).

    Joins at convex corners follow ``join_style``: ``"mitre"`` (intersection
    of offset lines, limited by ``mitre_limit * |distance|``), ``"round"``
    (circular arc with ``quad_segs`` segments per quarter turn), or
    ``"bevel"`` (straight connection).  Reflex corners always use the
    intersection of the adjacent offset lines.

    Mirrors ``shapely.geometry.Polygon.buffer`` as used by the reference
    (``superscreen/device/polygon.py:437-481``).
    """
    if distance == 0:
        return orient_ccw(points)
    p = remove_collinear(orient_ccw(points))
    n = len(p)
    d = float(distance)
    dirs = np.roll(p, -1, axis=0) - p
    lengths = np.linalg.norm(dirs, axis=1)
    if np.any(lengths == 0):
        raise PolygonOpError("Degenerate (zero-length) polygon edge.")
    dirs = dirs / lengths[:, None]
    # Outward normal for a CCW ring is (dy, -dx).
    normals = np.stack([dirs[:, 1], -dirs[:, 0]], axis=1)
    out: List[np.ndarray] = []
    for i in range(n):
        j = (i - 1) % n
        # Offset endpoints of the two edges meeting at vertex i.
        prev_end = p[i] + d * normals[j]
        next_start = p[i] + d * normals[i]
        cross = dirs[j][0] * dirs[i][1] - dirs[j][1] * dirs[i][0]
        convex_for_offset = (cross < 0) if d > 0 else (cross > 0)
        if abs(cross) < 1e-14:
            out.append(next_start)
            continue
        if convex_for_offset:
            # The offset edges diverge: join per style.
            if join_style in ("round", 1, "round_join"):
                a0 = np.arctan2(prev_end[1] - p[i][1], prev_end[0] - p[i][0])
                a1 = np.arctan2(next_start[1] - p[i][1], next_start[0] - p[i][0])
                sweep = a1 - a0
                # Take the short way matching the turn handedness.
                if d > 0:
                    while sweep > 0:
                        sweep -= 2 * np.pi
                else:
                    while sweep < 0:
                        sweep += 2 * np.pi
                n_arc = max(2, int(np.ceil(abs(sweep) / (np.pi / 2) * quad_segs)))
                angles = a0 + sweep * np.linspace(0, 1, n_arc + 1)
                arc = p[i] + abs(d) * np.stack(
                    [np.cos(angles), np.sin(angles)], axis=1
                )
                out.extend(arc)
                continue
            if join_style in ("bevel", 3):
                out.append(prev_end)
                out.append(next_start)
                continue
            # Mitre: intersect the two offset lines.
            mitre = _line_intersection(
                prev_end, dirs[j], next_start, dirs[i]
            )
            if (
                mitre is None
                or np.linalg.norm(mitre - p[i]) > mitre_limit * abs(d)
            ):
                out.append(prev_end)
                out.append(next_start)
            else:
                out.append(mitre)
        else:
            # Reflex for this offset direction: intersect the offset lines
            # (local trim); global loops are cleaned afterwards.
            x = _line_intersection(prev_end, dirs[j], next_start, dirs[i])
            if x is None:
                out.append(prev_end)
                out.append(next_start)
            else:
                out.append(x)
    ring = np.array(out)
    ring = _remove_loops(ring, outward=(d > 0))
    result = orient_ccw(ring)
    if signed_area(result) <= 0 or len(result) < 3:
        raise PolygonOpError("Buffer operation produced a degenerate polygon.")
    return result


def _line_intersection(p0, d0, p1, d1) -> Optional[np.ndarray]:
    denom = d0[0] * d1[1] - d0[1] * d1[0]
    if abs(denom) < 1e-14:
        return None
    t = ((p1[0] - p0[0]) * d1[1] - (p1[1] - p0[1]) * d1[0]) / denom
    return p0 + t * d0


# ---------------------------------------------------------------------------
# Resampling and distances
# ---------------------------------------------------------------------------


def resample_polygon(points: np.ndarray, num_points: int) -> np.ndarray:
    """Resamples the closed boundary to ``num_points`` approximately uniformly
    spaced vertices (the first output vertex coincides with the first input
    vertex).  Mirrors ``Polygon.resample`` in the reference
    (``superscreen/device/polygon.py:483-505``)."""
    p = _open_ring(points)
    closed = np.concatenate([p, p[:1]], axis=0)
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    targets = np.linspace(0, total, num_points, endpoint=False)
    x = np.interp(targets, s, closed[:, 0])
    y = np.interp(targets, s, closed[:, 1])
    return np.stack([x, y], axis=1)


def polygon_boundary_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Minimum distance between the boundaries of two polygons."""
    pa = _open_ring(a)
    pb = _open_ring(b)
    sa = np.stack([pa, np.roll(pa, -1, axis=0)], axis=1)
    sb = np.stack([pb, np.roll(pb, -1, axis=0)], axis=1)
    dmin = np.inf
    for a0, a1 in sa:
        d = _segments_to_segment_distance(sb, a0, a1)
        dmin = min(dmin, d)
    return float(dmin)


def _point_segment_distance_many(points: np.ndarray, s0, s1) -> np.ndarray:
    d = s1 - s0
    L2 = float(d @ d)
    if L2 == 0:
        return np.linalg.norm(points - s0, axis=-1)
    t = np.clip(((points - s0) @ d) / L2, 0.0, 1.0)
    proj = s0 + t[..., None] * d
    return np.linalg.norm(points - proj, axis=-1)


def _segments_to_segment_distance(segs: np.ndarray, a0, a1) -> float:
    # Distance from segment (a0, a1) to each segment in segs.
    d1 = _point_segment_distance_many(segs[:, 0], a0, a1).min()
    d2 = _point_segment_distance_many(segs[:, 1], a0, a1).min()
    best = min(d1, d2)
    for b0, b1 in segs:
        best = min(
            best,
            _point_segment_distance_many(np.array([a0, a1]), b0, b1).min(),
        )
        hit = _seg_intersect(a0, a1, b0, b1)
        if hit is not None:
            return 0.0
    return best

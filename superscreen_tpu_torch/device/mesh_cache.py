"""Opt-in on-disk cache for film triangulations.

Counterpart of ``superscreen_tpu/device/mesh_cache.py``, with the same
environment variable, key and entry format, so that the two packages share
one cache directory.  Meshing is deterministic host-side preprocessing
(``mesh_generation.py``) that costs seconds per film at ~20k sites, often
more than the factorization and solve on the card.  Since the
triangulation depends only on the input geometry and meshing parameters,
it can be cached on disk and reused across processes.

Enable by setting ``SUPERSCREEN_TPU_MESH_CACHE`` to a directory path; it
is off by default.  The key is a SHA-256 over a format version, the exact
float bytes of the outer boundary and every interior feature ring, and a
canonical encoding of the meshing parameters: any geometry or parameter
change misses.  Entries are ``.npz`` files holding ``points`` and
``triangles``; a corrupt or unreadable entry is a miss.
"""

import hashlib
import logging
import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("mesh_cache")

_FORMAT_VERSION = 1


def cache_dir() -> Optional[str]:
    """The cache directory, or None if the cache is disabled."""
    path = os.environ.get("SUPERSCREEN_TPU_MESH_CACHE", "").strip()
    return path or None


def cache_key(
    outer: np.ndarray,
    feature_rings: Sequence[np.ndarray],
    params: dict,
) -> str:
    """Content hash of the triangulation inputs."""
    h = hashlib.sha256()
    h.update(f"v{_FORMAT_VERSION}".encode())
    out = np.ascontiguousarray(np.asarray(outer, dtype=np.float64))
    h.update(str(out.shape).encode())
    h.update(out.tobytes())
    for ring in feature_rings:
        r = np.ascontiguousarray(np.asarray(ring, dtype=np.float64))
        h.update(str(r.shape).encode())
        h.update(r.tobytes())
    # Canonical, order-independent parameter encoding.
    h.update(repr(sorted(params.items())).encode())
    return h.hexdigest()


def load(key: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The cached ``(points, triangles)`` for ``key``, or None."""
    root = cache_dir()
    if root is None:
        return None
    path = os.path.join(root, f"{key}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            points = np.asarray(data["points"], dtype=np.float64)
            triangles = np.asarray(data["triangles"], dtype=np.int64)
        if points.ndim != 2 or points.shape[1] != 2:
            raise ValueError(f"bad points shape {points.shape}")
        if triangles.ndim != 2 or triangles.shape[1] != 3:
            raise ValueError(f"bad triangles shape {triangles.shape}")
        if triangles.size and triangles.max() >= len(points):
            raise ValueError("triangle index out of range")
        logger.debug("mesh cache hit: %s (%d sites)", key[:12], len(points))
        return points, triangles
    except Exception as exc:
        logger.info("mesh cache entry %s unreadable (%r); re-meshing", key[:12], exc)
        return None


def store(key: str, points: np.ndarray, triangles: np.ndarray) -> None:
    """Writes a cache entry (atomically via rename; best-effort)."""
    root = cache_dir()
    if root is None:
        return
    try:
        os.makedirs(root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=root, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(
                    fh,
                    points=np.asarray(points, dtype=np.float64),
                    triangles=np.asarray(triangles, dtype=np.int64),
                )
            os.replace(tmp, os.path.join(root, f"{key}.npz"))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        logger.debug("mesh cache store: %s (%d sites)", key[:12], len(points))
    except Exception as exc:  # pragma: no cover - disk full etc.
        logger.info("mesh cache store failed (%r); continuing", exc)

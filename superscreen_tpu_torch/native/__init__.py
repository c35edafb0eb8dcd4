"""The host geometry core: Delaunay triangulation and point and segment
tests in C++, bound with ``ctypes``.

Counterpart of ``superscreen_tpu/native``, from this package's own copy of
the source (``geomcore.cpp``), plus :func:`points_in_ring`, the crossing
test of :func:`superscreen_tpu_torch.device.polygon.points_in_ring_plain`
(matplotlib's decision for points on an edge).  The library is compiled at
first use, never at import, by ``$CXX`` (else ``g++``, else ``c++``) with
``-O3 -std=c++17 -shared -fPIC -ffp-contract=off`` into
``superscreen_tpu_torch/_build`` (named by a hash of the source and the
command), through a temporary file renamed into place, so processes that build
it at once never load a partial file.

A missing compiler, a failed compile or a failed load raises
``RuntimeError`` naming the command and its output: nothing falls back.
``SUPERSCREEN_TPU_NATIVE=0`` is an explicit request for the plain routes
(SciPy's Delaunay, the NumPy crossing test); :func:`available` is then
False and the request is logged once.  The one fallback the JAX package
also takes stays: when the Bowyer-Watson routine itself reports failure,
:func:`delaunay` returns None, the mesher triangulates that call with SciPy,
and ``STATS["delaunay_fallbacks"]`` counts it.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("native")

__all__ = [
    "STATS",
    "available",
    "compiler",
    "delaunay",
    "load_library",
    "points_in_polygon",
    "points_in_ring",
    "segments_intersect_batch",
]

#: ``delaunay_fallbacks``: calls the Bowyer-Watson routine could not
#: finish (the mesher took SciPy's Delaunay for them);
#: ``build_seconds``: the wall time of this process's compile, if it
#: compiled the library.
STATS = {"delaunay_fallbacks": 0, "build_seconds": None}

_SRC = Path(__file__).resolve().parent / "geomcore.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_disabled_logged = False


def _disabled() -> bool:
    """Whether ``SUPERSCREEN_TPU_NATIVE=0`` asks for the plain routes."""
    global _disabled_logged
    if os.environ.get("SUPERSCREEN_TPU_NATIVE", "1") != "0":
        return False
    if not _disabled_logged:
        _disabled_logged = True
        logger.info("SUPERSCREEN_TPU_NATIVE=0: the geometry core is not used.")
    return True


def compiler() -> str:
    """The C++ compiler the core is built with: ``$CXX``, else ``g++``,
    else ``c++`` on the ``PATH``.  Raises ``RuntimeError`` if none is
    found."""
    cxx = os.environ.get("CXX")
    if cxx:
        return cxx
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        "No C++ compiler found (tried $CXX, g++, c++); superscreen_tpu_torch "
        "compiles its geometry core (native/geomcore.cpp) at first use. Set "
        "CXX, or SUPERSCREEN_TPU_NATIVE=0 for the plain NumPy/SciPy routes."
    )


def _build(cxx: str, target: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    try:
        tmp = work / target.name
        cmd = [cxx, *_FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            result = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise RuntimeError(f"Could not run the C++ compiler: {' '.join(cmd)}\n{exc}") from exc
        if result.returncode != 0:
            raise RuntimeError(
                f"Building the geometry core failed ({result.returncode}):\n"
                f"{' '.join(cmd)}\n{result.stdout}{result.stderr}"
            )
        os.replace(tmp, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    dbl, i32, u8 = (ctypes.POINTER(t) for t in (ctypes.c_double, ctypes.c_int, ctypes.c_uint8))
    lib.delaunay.argtypes = [dbl, ctypes.c_int, i32, ctypes.c_int]
    lib.delaunay.restype = ctypes.c_int
    for name in ("points_in_polygon", "points_in_ring"):
        fn = getattr(lib, name)
        fn.argtypes = [dbl, ctypes.c_int, dbl, ctypes.c_int, u8]
        fn.restype = None
    lib.segments_intersect_batch.argtypes = [dbl, dbl, dbl, dbl, ctypes.c_int, u8]
    lib.segments_intersect_batch.restype = None
    return lib


def load_library() -> ctypes.CDLL:
    """Builds (if the source or the command changed) and loads the core.
    Raises ``RuntimeError`` if it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = compiler()
            digest = hashlib.sha256(" ".join((cxx,) + _FLAGS).encode())
            digest.update(_SRC.read_bytes())
            target = _BUILD_DIR / f"libgeomcore_{digest.hexdigest()[:16]}.so"
            if not target.exists():
                t0 = time.perf_counter()
                _build(cxx, target)
                STATS["build_seconds"] = time.perf_counter() - t0
            try:
                _lib = _bind(ctypes.CDLL(str(target)))
            except OSError as exc:
                raise RuntimeError(f"Could not load the geometry core {target}: {exc}") from exc
        return _lib


def available() -> bool:
    """False when ``SUPERSCREEN_TPU_NATIVE=0`` asks for the plain routes;
    else the core is built and loaded (raising if that fails) and True."""
    if _disabled():
        return False
    load_library()
    return True


def _doubles(arr) -> np.ndarray:
    """``arr`` as a C-contiguous float64 ``(k, 2)`` array (the layout the
    routines read), or ``ValueError``."""
    arr = np.ascontiguousarray(np.atleast_2d(arr), dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"Expected coordinates of shape (k, 2), got {arr.shape}.")
    return arr


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def delaunay(points: np.ndarray) -> Optional[np.ndarray]:
    """Delaunay triangulation by the Bowyer-Watson routine.

    The points are jittered by ``1e-9`` of their span with a fixed seed
    (``default_rng(12345)``; mesh point sets are exactly cocircular, which
    plain double predicates cannot decide), and the triangles are turned
    counterclockwise, as SciPy returns them.

    Args:
        points: ``(n, 2)`` coordinates.

    Returns:
        ``(m, 3)`` int64 triangle indices, or None if the routine ran out
        of room or failed (the caller then triangulates with SciPy).
    """
    lib = load_library()
    points = _doubles(points)
    span = max(np.ptp(points[:, 0]), np.ptp(points[:, 1]), 1e-300)
    jitter = np.random.default_rng(12345).uniform(-1.0, 1.0, size=points.shape)
    jittered = np.ascontiguousarray(points + 1e-9 * span * jitter)
    n = len(points)
    max_tris = 2 * n + 16
    out = np.empty((max_tris, 3), dtype=np.int32)
    count = lib.delaunay(_ptr(jittered, ctypes.c_double), n, _ptr(out, ctypes.c_int), max_tris)
    if count < 0:
        STATS["delaunay_fallbacks"] += 1
        return None
    tris = np.ascontiguousarray(out[:count]).astype(np.int64)
    xy = points[tris]
    signed = 0.5 * np.linalg.det(xy[:, [2, 0]] - xy[:, [1, 2]])
    flip = signed < 0
    tris[flip] = tris[flip][:, ::-1]
    return tris


def points_in_polygon(poly: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Even-odd ray casting of ``query`` ``(n, 2)`` against the open ring
    ``poly`` ``(m, 2)`` (the JAX package's ``native.points_in_polygon``;
    it decides points on an edge otherwise than matplotlib)."""
    lib = load_library()
    poly, query = _doubles(poly), _doubles(query)
    out = np.empty(len(query), dtype=np.uint8)
    lib.points_in_polygon(
        _ptr(poly, ctypes.c_double), len(poly), _ptr(query, ctypes.c_double), len(query),
        _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def points_in_ring(ring: np.ndarray, points: np.ndarray) -> np.ndarray:
    """matplotlib's crossing test of ``points`` ``(n, 2)`` against the
    closed ``ring`` ``(m, 2)`` (its last vertex is replaced by its first),
    bit for bit the decision of
    :func:`superscreen_tpu_torch.device.polygon.points_in_ring_plain`."""
    lib = load_library()
    ring, points = _doubles(ring), _doubles(points)
    out = np.empty(len(points), dtype=np.uint8)
    lib.points_in_ring(
        _ptr(ring, ctypes.c_double), len(ring), _ptr(points, ctypes.c_double), len(points),
        _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def segments_intersect_batch(a0, a1, b0, b1) -> np.ndarray:
    """Whether each segment ``a0[i] -> a1[i]`` crosses ``b0[i] -> b1[i]``
    strictly inside both."""
    lib = load_library()
    a0, a1, b0, b1 = (_doubles(v) for v in (a0, a1, b0, b1))
    if not len(a0) == len(a1) == len(b0) == len(b1):
        raise ValueError("The four segment end arrays must have the same length.")
    out = np.empty(len(a0), dtype=np.uint8)
    lib.segments_intersect_batch(
        *(_ptr(v, ctypes.c_double) for v in (a0, a1, b0, b1)), len(a0), _ptr(out, ctypes.c_uint8)
    )
    return out.astype(bool)

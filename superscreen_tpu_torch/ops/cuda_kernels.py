"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

The sources live in ``superscreen_tpu_torch/csrc``.  At first use each is
compiled by its own ``nvcc`` process, all started together, and the
objects are linked into one shared library with a plain C interface
under ``superscreen_tpu_torch/_build`` (named by a hash of the sources and
flags, so an edited source is rebuilt) and bound with ``ctypes``.  Nothing
is compiled or loaded when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch failed.  ``LAUNCHES`` counts the launches of each
kernel.  The pairwise kernels split their source range over blocks; the
grid arithmetic is done here, from the block geometry each kernel's
library reports (``sstt_<kernel>_geometry``), so the two sides cannot
drift.  ``residual_f64``'s plan (:func:`residual_plan`: route, persistent
grid, split-K) is computed here from the constants of its source, whose
entry point refuses a plan cut for other ones.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

__all__ = [
    "LAUNCHES",
    "load_library",
    "q_matrix",
    "q_matrix_rect",
    "biot_savart_batch",
    "q_apply",
    "biot_savart_pair",
    "residual_f64",
    "residual_plan",
    "residual_occupancy",
    "ResidualPlan",
    "RESIDUAL_MMA_MIN_K",
    "RESIDUAL_MMA_MIN_K_ALIGNED",
]

#: Launch counts per kernel; a wrapper adds one each time it launches.
LAUNCHES = {
    "q_matrix": 0, "biot_savart_batch": 0, "q_apply": 0, "biot_savart_pair": 0, "residual_f64": 0,
}

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE_DIR / "csrc"
_BUILD_DIR = _PACKAGE_DIR / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
_SUPPORTED = (torch.float32, torch.float64)

# Blocks per SM that the split of a pairwise kernel's source range aims
# for: at least _MIN_BLOCKS_PER_SM (16 warps of 128-thread blocks, enough
# to hide the rsqrt and FMA latencies) where the problem has that much
# work, and at most _MAX_BLOCKS_PER_SM, which bounds the partial sums.
_MIN_BLOCKS_PER_SM = 4
_MAX_BLOCKS_PER_SM = 8

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_geometries: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc was not found (set CUDA_HOME); the CUDA kernels of "
        "superscreen_tpu_torch are compiled from source at first use."
    )


def _build(sources, target: Path) -> None:
    """Compiles each of ``sources`` into an object file, all ``nvcc``
    processes started together, links them into ``target`` through a
    temporary file that is renamed into place (so concurrent builders never
    see a partial file), and removes the objects."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    try:
        objects, procs = [], []
        for source in sources:
            obj = work / f"{Path(source).stem}.o"
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(source)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objects.append(str(obj))
        failures = []
        for cmd, proc in procs:
            output = proc.communicate()[0]
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}")
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = work / target.name
        cmd = [nvcc, *_LINK_FLAGS, "-o", str(tmp), *objects]
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({result.returncode}):\n{' '.join(cmd)}\n"
                f"{result.stdout}\n{result.stderr}"
            )
        os.replace(tmp, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for suffix, scalar in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"sstt_q_matrix_{suffix}")
        fn.argtypes = [ptr, i64, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"sstt_q_matrix_rect_{suffix}")
        fn.argtypes = [ptr, i64, ptr, i64, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"sstt_biot_savart_{suffix}")
        fn.argtypes = [ptr, ptr, ptr, ptr, scalar, i64, i64, i64, i64, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"sstt_q_apply_{suffix}")
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"sstt_biot_savart_pair_{suffix}")
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, scalar, i64, i64, i64, i64, i64,
                       ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    for kernel in ("q_apply", "biot_savart", "biot_savart_pair"):
        fn = getattr(lib, f"sstt_{kernel}_geometry")
        fn.argtypes = [ctypes.c_int, i64, ctypes.POINTER(i64), ctypes.POINTER(i64)]
        fn.restype = None
    c_int = ctypes.c_int
    lib.sstt_residual_f64.argtypes = [
        ptr, ptr, c_int, i64, i64, ptr, c_int, ptr, c_int, i64, i64, i64, c_int,
        i64, i64, i64, i64, i64, i64, ptr, ptr,
    ]
    lib.sstt_residual_f64.restype = ctypes.c_int
    lib.sstt_residual_geometry.argtypes = [
        c_int, i64, c_int, ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.sstt_residual_geometry.restype = None
    return lib


def load_library() -> ctypes.CDLL:
    """Builds (if the sources changed) and loads the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            sources = sorted(_CSRC.glob("*.cu"))
            digest = hashlib.sha256(" ".join(_NVCC_FLAGS + _LINK_FLAGS).encode())
            for path in sorted(_CSRC.glob("*.cu*")):
                digest.update(path.name.encode())
                digest.update(path.read_bytes())
            target = _BUILD_DIR / f"libsstt_kernels_{digest.hexdigest()[:16]}.so"
            if not target.exists():
                _build(sources, target)
            _lib = _bind(ctypes.CDLL(str(target)))
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}.")
    if t.dtype != dtype:
        raise TypeError(f"{name} must have dtype {dtype}, got {t.dtype}.")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}.")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous.")
    # (x, y) pairs are read with one vector load each.
    if shape[-1] == 2 and t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"{name} must be aligned to {2 * t.element_size()} bytes.")


def _same_device(reference: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {reference} on {ref.device}.")


def _raise_on_error(kernel: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch (cudaError {code}).")


def _suffix(dtype: torch.dtype) -> str:
    if dtype not in _SUPPORTED:
        raise TypeError(f"CUDA kernels support float32 and float64, got {dtype}.")
    return "f32" if dtype == torch.float32 else "f64"


def q_matrix(points: torch.Tensor) -> torch.Tensor:
    """``q_ij = 1/(4 pi |r_i - r_j|^3)`` with zero diagonal (and zero at
    coincident points) for ``(n, 2)`` CUDA ``points``; returns ``(n, n)``."""
    suffix = _suffix(points.dtype)
    n = points.shape[0]
    _check("points", points, points.dtype, (n, 2))
    out = torch.empty((n, n), dtype=points.dtype, device=points.device)
    with torch.cuda.device(points.device):
        lib = load_library()
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"sstt_q_matrix_{suffix}")(
            points.data_ptr(), n, out.data_ptr(), stream
        )
    _raise_on_error("q_matrix", code)
    LAUNCHES["q_matrix"] += 1
    return out


def q_matrix_rect(eval_sites: torch.Tensor, src_sites: torch.Tensor) -> torch.Tensor:
    """The block ``q(eval_sites, src_sites)`` ``(m, n)`` of the same kernel
    for ``(m, 2)`` and ``(n, 2)`` CUDA points: zero where a pair
    coincides, so a row block ``q(points[r0:r1], points)`` of the square
    matrix has its diagonal, at column ``r0 + i`` of row ``i``, zero as
    :func:`q_matrix` leaves it.  Counted as a ``q_matrix`` launch."""
    suffix = _suffix(eval_sites.dtype)
    m, n = eval_sites.shape[0], src_sites.shape[0]
    _check("eval_sites", eval_sites, eval_sites.dtype, (m, 2))
    _check("src_sites", src_sites, eval_sites.dtype, (n, 2))
    _same_device("eval_sites", eval_sites, src_sites=src_sites)
    out = torch.empty((m, n), dtype=eval_sites.dtype, device=eval_sites.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(eval_sites.device):
        lib = load_library()
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"sstt_q_matrix_rect_{suffix}")(
            eval_sites.data_ptr(), m, src_sites.data_ptr(), n, out.data_ptr(), stream
        )
    _raise_on_error("q_matrix", code)
    LAUNCHES["q_matrix"] += 1
    return out


def _geometry(kernel: str, dtype: torch.dtype, cols: int) -> tuple:
    """``(evaluation points per block, source points per tile)`` of the
    pairwise kernel ``kernel`` (``q_apply``, ``biot_savart`` or
    ``biot_savart_pair``) in ``dtype`` for ``cols`` columns (``k`` or
    ``B``), as its library reports them."""
    key = (kernel, dtype, cols)
    if key not in _geometries:
        points, tile = ctypes.c_int64(), ctypes.c_int64()
        getattr(load_library(), f"sstt_{kernel}_geometry")(
            int(dtype == torch.float64), cols, ctypes.byref(points), ctypes.byref(tile)
        )
        _geometries[key] = (points.value, tile.value)
    return _geometries[key]


@functools.lru_cache(maxsize=None)
def _source_splits(n_src: int, tile: int, eval_blocks: int, sms: int) -> int:
    """Splits of a source range of ``n_src`` points, whole tiles of
    ``tile`` points each (as ``split_length`` in ``csrc/common.cuh`` cuts
    them), for a grid of ``eval_blocks`` evaluation blocks on ``sms`` SMs.

    Among the splits that put between ``_MIN_BLOCKS_PER_SM`` and
    ``_MAX_BLOCKS_PER_SM`` blocks on each SM (fewer where the problem is
    smaller, one split where the evaluation blocks alone exceed that), it
    takes the one whose busiest SM, holding ``ceil(blocks / sms)`` blocks,
    works through the fewest source tiles, and the fewest splits among
    equals.  No split is empty.
    """
    tiles = -(-n_src // tile)
    most = max(eval_blocks, _MAX_BLOCKS_PER_SM * sms)
    least = min(_MIN_BLOCKS_PER_SM * sms, eval_blocks * tiles, most)
    best_cost, best = None, 1
    for splits in range(1, min(tiles, 65535, most // eval_blocks) + 1):
        length = -(-tiles // splits)  # tiles per split, as split_length cuts them
        blocks = eval_blocks * splits
        if blocks < least or (splits - 1) * length >= tiles:  # an empty last split
            continue
        cost = -(-blocks // sms) * length
        if best_cost is None or cost < best_cost:
            best_cost, best = cost, splits
    return best


def _partial_shapes(kernel: str, dtype: torch.dtype, n_eval: int, n_src: int, cols: int,
                    sms: int) -> list:
    """Shapes of the partial sums a launch of ``kernel`` writes, as the C
    side indexes them: ``q_apply`` ``(splits, m, k)``; ``biot_savart``
    ``(splits, B, n2)``; ``biot_savart_pair`` that and the reverse sums
    ``(eval_blocks, B, n1)``.  The first dimension is what the launch is
    given as ``splits`` (and ``eval_blocks``)."""
    points, tile = _geometry(kernel, dtype, cols)
    eval_blocks = -(-n_eval // points)
    splits = _source_splits(n_src, tile, eval_blocks, sms)
    if kernel == "q_apply":
        return [(splits, n_eval, cols)]
    shapes = [(splits, cols, n_eval)]
    if kernel == "biot_savart_pair":
        shapes.append((eval_blocks, cols, n_src))
    return shapes


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def biot_savart_batch(
    src_sites: torch.Tensor,
    src_areas: torch.Tensor,
    J: torch.Tensor,
    dst_sites: torch.Tensor,
    dz2: float,
) -> torch.Tensor:
    """Field at ``dst_sites`` (``(n2, 2)``) from the sheet currents ``J``
    (``(B, n1, 2)``) at ``src_sites`` (``(n1, 2)``) with vertex areas
    ``src_areas`` (``(n1,)``), at squared height difference ``dz2``.
    Returns ``(B, n2)``."""
    suffix = _suffix(src_sites.dtype)
    dtype = src_sites.dtype
    n1, n2 = src_sites.shape[0], dst_sites.shape[0]
    if J.ndim != 3:
        raise ValueError(f"J must have shape (B, n1, 2), got {tuple(J.shape)}.")
    B = J.shape[0]
    _check("src_sites", src_sites, dtype, (n1, 2))
    _check("src_areas", src_areas, dtype, (n1,))
    _check("J", J, dtype, (B, n1, 2))
    _check("dst_sites", dst_sites, dtype, (n2, 2))
    _same_device("src_sites", src_sites, src_areas=src_areas, J=J, dst_sites=dst_sites)
    (shape,) = _partial_shapes("biot_savart", dtype, n2, n1, B, _sm_count(src_sites.device))
    splits = shape[0]
    partial = torch.empty(shape, dtype=dtype, device=src_sites.device)
    out = torch.empty((B, n2), dtype=dtype, device=src_sites.device)
    with torch.cuda.device(src_sites.device):
        lib = load_library()
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"sstt_biot_savart_{suffix}")(
            src_sites.data_ptr(), src_areas.data_ptr(), J.data_ptr(),
            dst_sites.data_ptr(), float(dz2), n1, n2, B, splits,
            partial.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on_error("biot_savart_batch", code)
    LAUNCHES["biot_savart_batch"] += 1
    return out


def q_apply(eval_sites: torch.Tensor, src_sites: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``(1/4 pi) q(eval_sites, src_sites) @ V`` with
    ``q = |r_eval - r_src|^-3`` and zero at coincident points, for
    ``(m, 2)`` ``eval_sites``, ``(n, 2)`` ``src_sites`` and ``(n, k)``
    ``V``.  Returns ``(m, k)``; ``q`` is never stored."""
    suffix = _suffix(eval_sites.dtype)
    dtype = eval_sites.dtype
    m, n = eval_sites.shape[0], src_sites.shape[0]
    if V.ndim != 2:
        raise ValueError(f"V must have shape (n, k), got {tuple(V.shape)}.")
    k = V.shape[1]
    _check("eval_sites", eval_sites, dtype, (m, 2))
    _check("src_sites", src_sites, dtype, (n, 2))
    _check("V", V, dtype, (n, k))
    _same_device("eval_sites", eval_sites, src_sites=src_sites, V=V)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, k), dtype=dtype, device=eval_sites.device)
    (shape,) = _partial_shapes("q_apply", dtype, m, n, k, _sm_count(eval_sites.device))
    splits = shape[0]
    partial = torch.empty(shape, dtype=dtype, device=eval_sites.device)
    out = torch.empty((m, k), dtype=dtype, device=eval_sites.device)
    with torch.cuda.device(eval_sites.device):
        lib = load_library()
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"sstt_q_apply_{suffix}")(
            eval_sites.data_ptr(), src_sites.data_ptr(), V.data_ptr(),
            m, n, k, splits, partial.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on_error("q_apply", code)
    LAUNCHES["q_apply"] += 1
    return out


def biot_savart_pair(
    sites1: torch.Tensor,
    areas1: torch.Tensor,
    J1: torch.Tensor,
    sites2: torch.Tensor,
    areas2: torch.Tensor,
    J2: torch.Tensor,
    dz2: float,
):
    """Both directions of a film pair from one geometry pass: the field at
    ``sites2`` from the currents ``J1`` (``(B, n1, 2)``) of film 1 and the
    field at ``sites1`` from ``J2`` (``(B, n2, 2)``) of film 2, at squared
    height difference ``dz2``.  Returns ``((B, n2), (B, n1))``."""
    suffix = _suffix(sites1.dtype)
    dtype = sites1.dtype
    n1, n2 = sites1.shape[0], sites2.shape[0]
    if J1.ndim != 3:
        raise ValueError(f"J1 must have shape (B, n1, 2), got {tuple(J1.shape)}.")
    B = J1.shape[0]
    _check("sites1", sites1, dtype, (n1, 2))
    _check("areas1", areas1, dtype, (n1,))
    _check("J1", J1, dtype, (B, n1, 2))
    _check("sites2", sites2, dtype, (n2, 2))
    _check("areas2", areas2, dtype, (n2,))
    _check("J2", J2, dtype, (B, n2, 2))
    _same_device("sites1", sites1, areas1=areas1, J1=J1, sites2=sites2, areas2=areas2, J2=J2)
    fwd_shape, rev_shape = _partial_shapes(
        "biot_savart_pair", dtype, n2, n1, B, _sm_count(sites1.device)
    )
    splits, eval_blocks = fwd_shape[0], rev_shape[0]
    fwd_partial = torch.empty(fwd_shape, dtype=dtype, device=sites1.device)
    rev_partial = torch.empty(rev_shape, dtype=dtype, device=sites1.device)
    out2 = torch.empty((B, n2), dtype=dtype, device=sites1.device)
    out1 = torch.empty((B, n1), dtype=dtype, device=sites1.device)
    with torch.cuda.device(sites1.device):
        lib = load_library()
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"sstt_biot_savart_pair_{suffix}")(
            sites1.data_ptr(), areas1.data_ptr(), J1.data_ptr(),
            sites2.data_ptr(), areas2.data_ptr(), J2.data_ptr(), float(dz2),
            n1, n2, B, splits, eval_blocks, fwd_partial.data_ptr(), rev_partial.data_ptr(),
            out2.data_ptr(), out1.data_ptr(), stream,
        )
    _raise_on_error("biot_savart_pair", code)
    LAUNCHES["biot_savart_pair"] += 1
    return out2, out1


# residual_f64's geometry, as csrc/residual_f64.cuh fixes it (the C entry
# point refuses a plan whose rows or tile differ from its own): 256-thread
# blocks, _RESIDUAL_BLOCKS_PER_SM of them on each SM; the stream route
# takes 64 rows by k columns per work item and 64 columns of A per stage,
# the tensor-core route 128 rows by 16, 32 or 64 columns and 32 columns of
# A per stage.
_RESIDUAL_BLOCKS_PER_SM = 2
_RESIDUAL_STREAM = dict(rows=64, tile=64)
_RESIDUAL_MMA = dict(rows=128, tile=32)
_RESIDUAL_ROUTES = ("stream", "mma")
# A work item's ring fills before its first tile is summed and its sums
# are reduced and stored after its last: about this many tiles' time.
_RESIDUAL_ITEM_OVERHEAD_TILES = 2
_RESIDUAL_MAX_SPLITS = 64
# The bytes of A that the rows of the blocks in flight may span.  Measured
# on an H100 80GB HBM3 at 700 W (tools/kernel_turns.py's split sweep): at
# 20,274^2, k = 1, 1,370 MB of rows in flight ran at 56 % of the bound,
# 685 MB at 66 %, 343 MB at 75 %; at 16,768^2 the span mattered within
# 2-3 % either way.
_RESIDUAL_SPAN_BYTES = 600e6
# Below this k the 4 m n bytes of A take longer than the 2 m n k
# operations at the FP64 tensor cores' rate (2 x 67e12 / 3.35e12).
_RESIDUAL_BYTES_BOUND_K = 40

#: Columns of X from which ``residual_f64`` takes the FP64 tensor-core
#: route (below, the stream route, which the C side instantiates for
#: these widths only) where the rows of A are not all 16-byte aligned,
#: and where they are (the stream route's TMA): see :func:`residual_plan`.
RESIDUAL_MMA_MIN_K = 6
RESIDUAL_MMA_MIN_K_ALIGNED = 12


@dataclass(frozen=True)
class ResidualPlan:
    """How one ``residual_f64`` call cuts its work (:func:`residual_plan`)."""

    route: str          # "stream" or "mma"
    width: int          # columns of R per work item: k, or 16, 32 or 64
    rows: int           # rows of A per work item
    tile: int           # columns of A per shared-memory stage
    tiles: int          # ceil(n / tile)
    splits: int         # the tiles cut into this many runs (split-K) ...
    split_tiles: int    # ... of this many whole tiles each, the last shorter
    row_blocks: int
    col_blocks: int
    grid: int           # blocks of the persistent grid

    @property
    def items(self) -> int:
        """Work items: row blocks x column blocks x splits."""
        return self.row_blocks * self.col_blocks * self.splits


def residual_plan(m: int, n: int, k: int, sms: int = 132, aligned: bool = False) -> ResidualPlan:
    """The route, grid and split-K of one ``residual_f64`` call ``R = H +
    A X`` with ``A`` ``(m, n)`` and ``k`` columns, on a card of ``sms``
    SMs; ``aligned``: ``A`` starts at a multiple of 16 bytes and ``n`` is a
    multiple of 4 (every row 16-byte aligned: the stream route copies ``A``
    by TMA, otherwise by its cp.async windows).  The C side cuts the work
    with the same arithmetic.

    The route is the stream route for ``k < RESIDUAL_MMA_MIN_K_ALIGNED``
    (aligned) or ``k < RESIDUAL_MMA_MIN_K``, and the FP64 tensor-core route
    from there.  Reckoned: ``A`` takes 4 m n bytes at
    3.35 TB/s and 2 m n k operations at 67 TFLOP/s, equal at k ~ 40 (k ~ 20
    against the 33.5 TFLOP/s of the FP64 units the stream route uses), so
    both routes are bound by the bytes of ``A`` well past the switch.
    Measured on an NVIDIA H100 80GB HBM3 at 700 W (the two routes in turns,
    ``tools/kernel_turns.py --kernel residual`` on a build with stream
    widths to 16): at n = 16,768 (aligned) the stream route is faster up
    to k = 11 (0.477 against 0.494 ms), the tensor-core route from k = 12
    (0.464 against 0.480 ms); at n = 16,766 (rows 8 bytes off) the stream
    route is faster up to k = 4 (0.468 against 0.493 ms), even at 5 (0.5045
    both) and slower from 6 (0.527 against 0.503 ms).  Past the switch the
    stream route's instructions per float64 FMA, not its bytes, bound it,
    and its wider sums spill.  So the C side builds the stream route's TMA
    copies for ``k < RESIDUAL_MMA_MIN_K_ALIGNED`` and its windows for ``k <
    RESIDUAL_MMA_MIN_K`` only.

    The grid is persistent: ``sms`` times ``_RESIDUAL_BLOCKS_PER_SM``
    blocks (fewer if there are fewer work items) walk the work items, a
    block of rows (and, on the tensor-core route, of columns of R) times
    one split of the columns of A into whole tiles (the C side numbers the
    items with the column blocks, then the splits of one row block
    adjacent); the blocks an SM holds share its bandwidth and tensor
    cores.  Among the splits that leave no split empty, keep the partial
    sums (16 bytes each way per split and element of R) under a quarter of
    A's bytes and give every block slot (every SM from ``k`` = 40, where
    the operations bound the call) an item where the work allows, it
    prefers those whose blocks in flight walk rows that span at most
    ``_RESIDUAL_SPAN_BYTES`` of A (their row blocks are the grid's blocks
    over the splits and column blocks of each), and among them takes the
    one whose busiest SM works through the fewest tiles (``ceil(items /
    sms)`` items, each its tiles plus ``_RESIDUAL_ITEM_OVERHEAD_TILES``),
    and the fewest splits among equals.
    """
    if m < 1 or k < 1 or n < 0:
        raise ValueError(f"residual_plan needs m, k >= 1 and n >= 0, got {(m, n, k)}.")
    stream = k < (RESIDUAL_MMA_MIN_K_ALIGNED if aligned else RESIDUAL_MMA_MIN_K)
    return _route_plan(m, n, k, sms, "stream" if stream else "mma")


@functools.lru_cache(maxsize=None)
def _route_plan(m: int, n: int, k: int, sms: int, route: str) -> ResidualPlan:
    """:func:`residual_plan` on ``route`` (the tensor-core route takes
    any ``k``; the stream route the ``k`` that :func:`residual_plan` gives
    it at the alignment of ``A``)."""
    if route == "stream":
        width, geometry = k, _RESIDUAL_STREAM
    else:
        width, geometry = (16 if k <= 16 else 32 if k <= 32 else 64), _RESIDUAL_MMA
    rows, tile = geometry["rows"], geometry["tile"]
    tiles = -(-n // tile)
    row_blocks = -(-m // rows)
    col_blocks = 1 if route == "stream" else -(-k // width)
    blocks = row_blocks * col_blocks
    slots = sms * _RESIDUAL_BLOCKS_PER_SM
    most = max(1, min(_RESIDUAL_MAX_SPLITS, tiles, n // (16 * k)))
    # Where the bytes of A bound the call, every block slot streams; where
    # the tensor cores do, every SM computes.
    least_items = min(slots if k < _RESIDUAL_BYTES_BOUND_K else sms, blocks * most)
    best_cost, splits, split_tiles = None, 1, max(tiles, 1)
    for s in range(1, most + 1):
        length = -(-tiles // s)
        if (s - 1) * length >= tiles or blocks * s < least_items:  # an empty split; idle SMs
            continue
        in_flight = min(row_blocks, -(-min(blocks * s, slots) // (s * col_blocks)))
        wide = min(m, in_flight * rows) * n * 4 > _RESIDUAL_SPAN_BYTES
        cost = (wide, -(-blocks * s // sms) * (length + _RESIDUAL_ITEM_OVERHEAD_TILES))
        if best_cost is None or cost < best_cost:
            best_cost, splits, split_tiles = cost, s, length
    return ResidualPlan(
        route=route, width=width, rows=rows, tile=tile, tiles=tiles, splits=splits,
        split_tiles=split_tiles, row_blocks=row_blocks, col_blocks=col_blocks,
        grid=min(blocks * splits, slots),
    )


def residual_occupancy(plan: ResidualPlan, x_dtype: torch.dtype) -> tuple:
    """``(blocks per SM, dynamic shared bytes)`` of the instantiation that
    ``plan`` launches for an X of ``x_dtype``, as the occupancy calculator
    gives them (the plan assumes ``_RESIDUAL_BLOCKS_PER_SM``)."""
    blocks, smem = ctypes.c_int64(), ctypes.c_int64()
    load_library().sstt_residual_geometry(
        _RESIDUAL_ROUTES.index(plan.route), plan.width, int(x_dtype == torch.float64),
        ctypes.byref(blocks), ctypes.byref(smem),
    )
    return blocks.value, smem.value


def _rows_aligned(A: torch.Tensor) -> bool:
    """Whether every row of a row-major ``A`` starts at a multiple of 16
    bytes (the C side's test for the stream route's TMA copies)."""
    return A.data_ptr() % 16 == 0 and A.shape[1] % 4 == 0 and A.shape[1] > 0


def _column_strides(X: torch.Tensor) -> tuple:
    """``(row stride, column stride)`` of an ``(n, k)`` X that is
    row-major or the transpose of a row-major ``(k, n)``."""
    n, k = X.shape
    if X.is_contiguous():
        return k, 1
    if X.mT.is_contiguous():
        return 1, n
    raise ValueError("X must be contiguous or the transpose of a contiguous tensor.")


def residual_f64(
    A: torch.Tensor,
    X: torch.Tensor,
    H: Optional[torch.Tensor] = None,
    *,
    out_dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """``R = H + A @ X`` with every product and sum in float64 (widening
    ``A`` is exact) for a float32 ``A`` ``(m, n)``, a float32 or float64
    ``X`` ``(n, k)`` (row-major, or the transpose of a row-major
    ``(k, n)``: ``g.T`` is read in place) and a float32 or float64 ``H``
    ``(m, k)``, or ``None`` for zero.  Returns ``(m, k)`` in ``out_dtype``:
    float64, or float32 rounded once from the float64 sum (the bits of
    ``.to(torch.float32)`` of the float64 result).

    One call reads ``A`` once at any ``k`` and adds exactly 1 to
    ``LAUNCHES["residual_f64"]``; :func:`residual_plan` picks the route
    and the split-K.  Where the plan splits the
    columns of ``A``, the call ends with a second pass over the float64
    partial sums (a scratch buffer from ``torch.empty``) that adds them in
    a fixed order: part of the same call, not counted as a launch of its
    own.  Two calls on the same inputs give the same bits."""
    if A.ndim != 2 or X.ndim != 2:
        raise ValueError(
            f"A must have shape (m, n) and X (n, k), got {tuple(A.shape)} and {tuple(X.shape)}."
        )
    (m, n), k = A.shape, X.shape[1]
    _check("A", A, torch.float32, (m, n))
    if X.dtype not in _SUPPORTED:
        raise TypeError(f"X must be float32 or float64, got {X.dtype}.")
    if tuple(X.shape) != (n, k):
        raise ValueError(f"X must have shape {(n, k)}, got {tuple(X.shape)}.")
    xs_row, xs_col = _column_strides(X)
    if H is not None:
        if H.dtype not in _SUPPORTED:
            raise TypeError(f"H must be float32 or float64, got {H.dtype}.")
        _check("H", H, H.dtype, (m, k))
        _same_device("A", A, H=H)
    if out_dtype not in _SUPPORTED:
        raise TypeError(f"out_dtype must be float32 or float64, got {out_dtype}.")
    _same_device("A", A, X=X)
    out = torch.empty((m, k), dtype=out_dtype, device=A.device)
    if m == 0 or k == 0:
        return out
    plan = residual_plan(m, n, k, _sm_count(A.device), _rows_aligned(A))
    partial = (
        torch.empty((plan.splits, m, k), dtype=torch.float64, device=A.device)
        if plan.splits > 1 else None
    )
    with torch.cuda.device(A.device):
        lib = load_library()
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sstt_residual_f64(
            A.data_ptr(), X.data_ptr(), int(X.dtype == torch.float64), xs_row, xs_col,
            None if H is None else H.data_ptr(), int(H is not None and H.dtype == torch.float64),
            out.data_ptr(), int(out_dtype == torch.float64), m, n, k,
            _RESIDUAL_ROUTES.index(plan.route), plan.width, plan.rows, plan.tile, plan.grid,
            plan.splits, plan.split_tiles, None if partial is None else partial.data_ptr(),
            stream,
        )
    _raise_on_error("residual_f64", code)
    LAUNCHES["residual_f64"] += 1
    return out

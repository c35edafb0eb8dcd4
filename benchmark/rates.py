"""Peak rates of one NVIDIA H100 SXM and the least time a piece of work
can take on it: the yardstick of the per-layer roofline shares.

Copied from ``chip_smoke.py`` (``H100_RATES``, ``_flops_per_pair``,
``_bound``, ``_residual_bound``) so that the yardstick cannot move with the
program.  Each input is counted as read once and each output as written
once, whatever a kernel reads again.  The rates assume the card's full
700 W power limit; a reading prints the card's limit beside it.
"""

import subprocess

# Peak rates of an H100 SXM at its 700 W limit (132 SMs at 1.98 GHz;
# NVIDIA's data sheet): HBM bytes, FP32 and FP64 operations outside the
# tensor cores (an FMA counts 2), FP64 operations on the tensor cores
# (DMMA), and reciprocal square roots on the special-function units (16
# per clock per SM).
H100_RATES = {
    "bytes": 3.35e12, "float32": 66.9e12, "float64": 33.5e12, "float64_tensor": 67e12,
    "rsqrt": 4.18e12,
}


def flops_per_pair(kernel: str, cols: int) -> int:
    """Floating-point operations per pair besides the reciprocal square
    root: the differences, the squared distance and the cube, then per
    column one FMA (q_apply), two (biot_savart_batch, K = (dx, dy) r^-3
    formed once) or four (the pair kernel, both directions)."""
    return {"q_matrix": 8, "q_apply": 7 + 2 * cols, "biot_savart_batch": 10 + 4 * cols,
            "biot_savart_pair": 10 + 8 * cols}[kernel]


def pairwise_bound(kernel: str, dtype: str, n_eval: int, n_src: int, cols: int):
    """The least time in ms that the card could take for one pairwise
    launch, and what sets it: the inputs read and outputs written once over
    the HBM rate, the pairs' reciprocal square roots over the
    special-function rate, or their other operations over the FP32 (FP64)
    rate.  ``dtype`` is ``"float32"`` or ``"float64"``."""
    size = 4 if dtype == "float32" else 8
    pairs = n_eval * n_src
    values = {  # inputs read + outputs written
        "q_matrix": 2 * n_src + n_eval * n_src,
        "q_apply": 2 * n_eval + (2 + cols) * n_src + n_eval * cols,
        "biot_savart_batch": (3 + 2 * cols) * n_src + (2 + cols) * n_eval,
        "biot_savart_pair": (3 + 3 * cols) * (n_src + n_eval),
    }[kernel]
    times = {
        "bytes": values * size / H100_RATES["bytes"],
        "rsqrt": pairs / H100_RATES["rsqrt"],
        dtype: pairs * flops_per_pair(kernel, cols) / H100_RATES[dtype],
    }
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def residual_bound(m: int, n: int, k: int, x_size: int = 8, h_size: int = 8, r_size: int = 8):
    """The least time in ms for one ``residual_f64`` call ``h + A x``, and
    what sets it: the float32 ``A`` (m, n), ``X`` (n, k) and ``H`` (m, k)
    read once and ``R`` (m, k) written once over the HBM rate (element
    sizes in bytes), or the ``2 m n k`` float64 operations over the FP64
    tensor cores' rate."""
    times = {
        "bytes": (4 * m * n + x_size * n * k + (h_size + r_size) * m * k) / H100_RATES["bytes"],
        "float64_tensor": 2 * m * n * k / H100_RATES["float64_tensor"],
    }
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def apply_bound(n: int, k: int, size: int = 4):
    """The least time in ms for one product of a stored ``(n, n)`` operator
    (a factor or an explicit inverse, ``size`` bytes an entry) with ``k``
    columns: the operator read once over the HBM rate, or its ``2 n^2 k``
    operations over the FP32 rate."""
    times = {
        "bytes": (size * n * n + 2 * size * n * k) / H100_RATES["bytes"],
        "float32": 2 * n * n * k / H100_RATES["float32"],
    }
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def card_limits() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reads them
    ("not read" where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().replace("\n", "; ") or "not read"

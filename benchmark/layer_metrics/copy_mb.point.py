"""Bytes (MB) the program copied between the host and the card, both ways
(``d2h_bytes`` + ``h2d_bytes``), per drive point completed.  Reads
``superscreen_tpu_torch.tracing.snapshot()``, which the program fills while
the profiler of the traced run is open."""

from benchmark.readers import per_point


def read(ctx):
    try:
        from superscreen_tpu_torch import tracing
    except ImportError:  # a program without counters of its own
        return None
    counters = tracing.snapshot()["counters"]
    return per_point(ctx, (counters.get("d2h_bytes", 0) + counters.get("h2d_bytes", 0)) / 1e6)

"""Blocking reads of device values by the program (``host_syncs``: each
``.cpu()``, ``.item()``, ``float()`` or ``bool()`` of a tensor on the card)
per drive point completed.  Reads
``superscreen_tpu_torch.tracing.snapshot()``, which the program fills while
the profiler of the traced run is open."""

from benchmark.readers import per_point


def read(ctx):
    try:
        from superscreen_tpu_torch import tracing
    except ImportError:  # a program without counters of its own
        return None
    return per_point(ctx, tracing.snapshot()["counters"].get("host_syncs", 0))

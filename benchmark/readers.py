"""Arithmetic shared by the per-layer metric readers under
``layer_metrics/``: each reader is one line over these, on the traced
run's context (see README.md), and returns ``None`` where it finds nothing."""

import math


def roofline(ctx, span: str):
    """Share (%) of the least time of a device span's work (summed over
    its calls, :mod:`benchmark.rates`) in the device time under it."""
    device_s = ctx.span_device_s.get(span, 0.0)
    least_ms = ctx.least_ms.get(span, 0.0)
    if device_s <= 0 or not least_ms or not math.isfinite(least_ms):
        return None
    return 100 * least_ms / 1e3 / device_s


def idle_share(ctx, count: int):
    """Share (%) of the traced window in which no operation ran on the
    device, in a window that completed ``count`` points or models."""
    if ctx.busy_s <= 0 or ctx.window_s <= 0 or not count:
        return None
    return 100 * (1 - ctx.busy_s / ctx.window_s)


def per_point(ctx, value):
    """``value`` per drive point completed in the traced window."""
    if not value or not ctx.points:
        return None
    return value / ctx.points

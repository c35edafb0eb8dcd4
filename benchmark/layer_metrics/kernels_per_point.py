"""Device kernel launches of every library in the traced window, counted
by the profiler, per drive point completed."""

from benchmark.readers import per_point


def read(ctx):
    return per_point(ctx, ctx.kernels)

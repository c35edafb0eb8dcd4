"""Solves on packed LU factors (``triangular_solves``, counted in
``ops.linalg.lu_solve``: two triangular solves each) per drive point
completed.  Reads ``superscreen_tpu_torch.tracing.snapshot()``, which the
program fills while the profiler of the traced run is open.  A program
without the counter reads nothing; one with it reads 0 where every film
solves by a product."""


def read(ctx):
    try:
        from superscreen_tpu_torch import tracing
    except ImportError:  # a program without counters of its own
        return None
    if not hasattr(tracing, "TRIANGULAR_SOLVES") or not ctx.points:
        return None
    return tracing.snapshot()["counters"].get(tracing.TRIANGULAR_SOLVES, 0) / ctx.points

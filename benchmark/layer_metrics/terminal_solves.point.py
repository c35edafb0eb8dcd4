"""Refined LU solves of the terminal films' transport bootstrap
(``terminal_solves``, counted in ``solver.solve_film.solve_from_boundary_stream``)
per drive point completed.  Reads ``superscreen_tpu_torch.tracing.snapshot()``,
which the program fills while the profiler of the traced run is open; a
program without the counter reads nothing."""

from benchmark.readers import per_point


def read(ctx):
    try:
        from superscreen_tpu_torch import tracing
    except ImportError:  # a program without counters of its own
        return None
    return per_point(ctx, tracing.snapshot()["counters"].get("terminal_solves", 0))

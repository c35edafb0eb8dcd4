"""Host wall (ms) of the program's ``sweep.terminals`` spans
(``sweep._apply_terminal_sweeps``: the terminal films' bootstrap unit
solutions and their boundary fields, folded into per-point offsets) per
drive point completed.  Reads ``superscreen_tpu_torch.tracing.snapshot()``,
which the program fills while the profiler of the traced run is open; a
program without the span reads nothing."""

from benchmark.readers import per_point


def read(ctx):
    try:
        from superscreen_tpu_torch import tracing
    except ImportError:  # a program without spans of its own
        return None
    spans = tracing.snapshot()["spans"]
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "sweep.terminals" and s.end_ns)
    return per_point(ctx, ns / 1e6)

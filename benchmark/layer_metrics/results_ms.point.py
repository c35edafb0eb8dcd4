"""Host wall (ms) of the program's ``sweep.results`` spans (the results
copied to the host and the ``SweepResult`` or ``Solution``s built) per
drive point completed.  Reads ``superscreen_tpu_torch.tracing.snapshot()``,
which the program fills while the profiler of the traced run is open."""

from benchmark.readers import per_point


def read(ctx):
    try:
        from superscreen_tpu_torch import tracing
    except ImportError:  # a program without spans of its own
        return None
    spans = tracing.snapshot()["spans"]
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "sweep.results" and s.end_ns)
    return per_point(ctx, ns / 1e6)

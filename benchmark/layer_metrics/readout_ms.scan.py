"""Host wall (ms) of the program's ``scan.readout`` spans
(``squids.scanning._contour_flux``: the sample currents uploaded, the
pickup-loop readout tensors formed and the flux read back) per scan
position completed.  Reads ``superscreen_tpu_torch.tracing.snapshot()``,
which the program fills while the profiler of the traced run is open."""

from benchmark.readers import per_point


def read(ctx):
    try:
        from superscreen_tpu_torch import tracing
    except ImportError:  # a program without spans of its own
        return None
    spans = tracing.snapshot()["spans"]
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "scan.readout" and s.end_ns)
    return per_point(ctx, ns / 1e6)

"""The 95th percentile (ms) of the latency of every call in the window,
from the call to its results on the host."""

from benchmark.harness import p95


def read(w):
    return p95(w.latencies) * 1e3 if w.latencies else None

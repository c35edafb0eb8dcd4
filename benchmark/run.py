"""Runs one cell of BENCHMARK.json once on the card it is started on:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

prints the result as the last line of standard output (see README.md)."""

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for every numerical library: the window is one client's
# calls, and a pool of threads that contends for the host's cores makes
# runs of the same cell differ (scan64: 8 % apart with the default pools,
# 3 % with one thread, on an H100 machine of 8 cores).
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))

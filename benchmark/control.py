"""The control of a cell's comparison: the plain reference computed in
TF32 (float32 with every matrix product on TF32 operands, the precision
below the configuration's float32 with TF32 off) put in the program's
place, and judged as the program is.  A sound limit fails it.

    python3 benchmark/control.py --workload rings27k_sweep --seeds 11 12 13

draws each seed's first calls as a run of that seed does, and prints one
JSON line per seed: the control's reading of each call and the limit.
The benchmark's own runs do not run it."""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def control_readings(config, traffic, seed, calls, device):
    """The control's reading of each of the first ``calls`` draws of
    ``seed``'s window."""
    entry = harness.entry_class(traffic["entry"])(config, traffic, [device])
    rng = np.random.default_rng([seed, 0])
    draws = [entry.draw(rng) for _ in range(calls)]
    return entry.control(draws, device)


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--calls", type=int, default=None, help="calls per seed (default: a run's check_calls)")
    args = parser.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell, config, traffic, _, _ = harness.cell_inputs(harness.load_bench(), args.workload)
    calls = args.calls or int(traffic["check_calls"])
    limit = next(iter(config["limits"].values()))
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = control_readings(config, traffic, seed, calls, device)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": readings, "min": min(readings),
            "limit": limit, "fails": bool(min(readings) > limit), "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name() if device == "cuda" else "cpu",
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

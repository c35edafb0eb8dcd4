"""One run of one cell: set-up, the measured window, the trace reduction
of a traced run, the check against the plain reference, and the result
line (see README.md for the command and the contract it meets)."""

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import drives, rates, spans as spans_mod, trace as trace_mod

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that the measured process may never hold: JAX,
#: its libraries and the JAX package that the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "superscreen_tpu")


def forbidden_modules(modules=None):
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot), compared whole, is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def p95(values):
    """The 95th percentile of all values (linear interpolation between
    order statistics, as ``numpy.percentile``)."""
    return float(np.percentile(np.asarray(values, dtype=float), 95))


def load_bench(root: Path = ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_inputs(bench: dict, workload: str, root: Path = ROOT):
    """``(cell, config, traffic, per_layer, end_to_end)`` of a workload, each
    found by its name in ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"No workload {workload!r} in BENCHMARK.json ({sorted(cells)}).")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return (
        cell, config, traffic,
        [m for m in bench["per_layer"] if mine(m)],
        [m for m in bench["end_to_end"] if mine(m)],
    )


def _module(kind: str, name: str, root: Path):
    """The module ``benchmark/<kind>/<name>.py`` under ``root``."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def layer_reader(name: str, root: Path = ROOT, kind: str = "layer_metrics"):
    """The reader ``read(ctx)`` of the metric ``name``:
    ``benchmark/layer_metrics/<name>.py`` for a per-layer metric,
    ``benchmark/end_to_end/<name>.py`` for an end-to-end one."""
    return _module(kind, name, root).read


def entry_class(name: str, root: Path = ROOT):
    """The kind of call ``name`` (a traffic mix's ``entry``): ``ENTRY``, a
    :class:`drives.Entry` subclass, of ``benchmark/entries/<name>.py``."""
    return _module("entries", name, root).ENTRY


def cell_cards(torch_device: str, chips: int):
    """The cards of a cell of ``chips`` chips: ``cuda:0`` to
    ``cuda:<chips - 1>`` on the card, ``torch_device`` repeated elsewhere
    (a CPU rehearsal)."""
    if torch_device.startswith("cuda"):
        return [f"cuda:{i}" for i in range(chips)]
    return [torch_device] * chips


def run_cell(cell, config, traffic, per_layer, end_to_end, seed, seconds, trace, torch_device, t0, root: Path = ROOT):
    """Runs one cell and returns the result dict (see README.md); its kind
    of call and its metrics' readers are found under ``root``."""
    import torch

    import superscreen_tpu_torch as st

    on_card = torch_device.startswith("cuda")
    cards = cell_cards(torch_device, int(cell["chips"]))
    indices = sorted({torch.device(c).index or 0 for c in cards}) if on_card else []
    entry = entry_class(traffic["entry"], root)(config, traffic, cards)
    if on_card:
        torch.cuda.init()  # the allocator's statistics of a card exist from here
    for i in indices:
        torch.cuda.reset_peak_memory_stats(i)
    spans = spans_mod.Spans()
    tracing = spans_mod.installed(spans) if trace else _nothing()
    failures = []
    # Set-up's phases, for the run's record: start (imports, the card),
    # the model, and each warm call.
    phases = {"start": time.perf_counter() - t0}
    with tracing:
        entry.setup(st)
        _sync(torch, indices)
        phases["model"] = time.perf_counter() - t0 - sum(phases.values())
        warm = np.random.default_rng([seed, 2])
        for i in range(int(traffic.get("warm_calls", 2))):
            entry.call(entry.draw(warm))
            _sync(torch, indices)
            phases[f"warm{i}"] = time.perf_counter() - t0 - sum(phases.values())
        spans.reset()
        # What set-up made stays; the window's collections scan only what
        # the calls make.
        gc.collect()
        gc.freeze()
        rng = np.random.default_rng([seed, 0])
        kept = drives.Reservoir(int(traffic["check_calls"]), seed)
        latencies, points, models = [], 0, 0
        profiler = _profiler(torch, on_card) if trace else _nothing()
        with profiler as prof:
            start = time.perf_counter()
            setup_s = start - t0
            deadline = start + seconds
            while time.perf_counter() < deadline:
                params = entry.draw(rng)
                c0 = time.perf_counter()
                try:
                    out = entry.call(params)
                except Exception:  # a call that fails counts, and the run goes on
                    failures.append(traceback.format_exc())
                    latencies.append(time.perf_counter() - c0)
                    continue
                latencies.append(time.perf_counter() - c0)
                points += entry.points(params)
                models += entry.models_per_call
                kept.offer((params, out))
            _sync(torch, indices)
            window_s = time.perf_counter() - start
    peaks = [int(torch.cuda.max_memory_allocated(i)) for i in indices]
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": len(cards),
        "memory_peak_bytes": max(peaks, default=0),
    }
    if len(cards) > 1:
        device["memory_peak_bytes_per_card"] = peaks
    result = {"correct": None, "attempted": len(latencies), "failed": len(failures)}
    if trace:
        reduced = trace_mod.reduce(prof, indices or None)
        ctx = SimpleNamespace(
            points=points, models=models, calls=len(latencies), window_s=window_s,
            busy_s=reduced.busy_s, kernels=reduced.kernels, span_device_s=reduced.span_device_s,
            least_ms=dict(spans.least_ms), wall_s=dict(spans.wall_s),
            factorize=list(spans.factorize),
        )
        metrics = {}
        for m in per_layer:
            value = layer_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=reduced.busy_s, window_s=window_s)
        if len(cards) > 1:
            device["busy_s_per_card"] = reduced.busy_s_per_card
        result["breakdown"] = {"device_ops": reduced.device_ops, "idle_gaps": reduced.idle_gaps}
    else:
        window = SimpleNamespace(
            latencies=latencies, points=points, models=models, window_s=window_s, setup_s=setup_s
        )
        metrics = {}
        for m in end_to_end:
            value = layer_reader(m["name"], root, "end_to_end")(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    found = forbidden_modules()
    # The program's state goes before the reference runs on the same card.
    samples = kept.items
    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    checks = entry.check(samples, torch_device)
    reference_s = time.perf_counter() - r0
    result["correct"] = bool(not failures and not found and all(c.ok for c in checks))
    result["checks"] = {
        c.name: {"value": c.value if math.isfinite(c.value) else None, "limit": c.limit} for c in checks
    }
    info = dict(
        setup_s=setup_s, setup_phases_s=",".join(f"{k}:{v:.3f}" for k, v in phases.items()),
        window_s=window_s, calls=len(latencies), points=points, models=models,
        checked_calls=len(samples), reference_s=reference_s, card=rates.card_limits() if on_card else "cpu",
    )
    return result, failures, found, info


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _sync(torch, indices):
    """Waits for every card of the cell."""
    for i in indices:
        torch.cuda.synchronize(i)


def _profiler(torch, on_card):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return profile(activities=activities, record_shapes=False, profile_memory=False, with_stack=False)


def main(argv, t0):
    parser = argparse.ArgumentParser(description="Runs one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = load_bench()
    cell, config, traffic, per_layer, end_to_end = cell_inputs(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(
            f"benchmark: needs {cell['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}.",
            file=sys.stderr,
        )
        return 2
    result, failures, found, info = run_cell(
        cell, config, traffic, per_layer, end_to_end, args.seed, args.seconds, args.trace, "cuda", t0
    )
    if found:
        print(f"benchmark: the measured process holds {found}: JAX or the JAX package.", file=sys.stderr)
        return 3
    for text in failures[:3]:
        print(text, file=sys.stderr)
    print("benchmark: " + " ".join(f"{k}={v}" for k, v in info.items()), file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0

"""A configuration, a traffic mix or a per-layer metric that a later change
adds as new files beside the others is found by its name in
``BENCHMARK.json``, with no file of the harness edited."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("data", "__pycache__"))
    bench = harness.load_bench(ROOT)
    config = json.loads((ROOT / "benchmark/configs/four_ring_27k.json").read_text())
    config["name"] = "four_ring_27k_lu"
    (tmp_path / "benchmark/configs/four_ring_27k_lu.json").write_text(json.dumps(config))
    (tmp_path / "benchmark/traffic/sweep32.json").write_text(json.dumps(
        {"entry": "solve_many", "points_per_call": 32, "field_mT": [0.1, 1.0], "check_calls": 4}
    ))
    (tmp_path / "benchmark/layer_metrics/calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.calls / ctx.window_s if ctx.window_s else None\n"
    )
    bench["configs"].append({"name": "four_ring_27k_lu", "source": "x", "file": "benchmark/configs/four_ring_27k_lu.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "four_ring_27k_lu", "traffic": "sweep32", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "ms_per_point", "workloads": ["new_cell"]})
    bench["end_to_end"][0]["workloads"].append("new_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell, cfg, traffic, per_layer, e2e = harness.cell_inputs(harness.load_bench(tmp_path), "new_cell", tmp_path)
    assert cfg["name"] == "four_ring_27k_lu" and traffic["points_per_call"] == 32
    assert [m["name"] for m in per_layer] == ["calls_per_s"]
    assert {m["name"] for m in e2e} == {"ms_per_point", "setup_s"}
    assert harness.layer_reader("ms_per_point", tmp_path, "end_to_end")(SimpleNamespace(window_s=1.0, points=4)) == 250.0
    read = harness.layer_reader("calls_per_s", tmp_path)
    assert read(SimpleNamespace(calls=10, window_s=2.0)) == 5.0


def test_every_metric_has_its_reader_and_every_cell_its_files():
    bench = harness.load_bench(ROOT)
    for m in bench["per_layer"]:
        assert callable(harness.layer_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert callable(harness.layer_reader(m["name"], kind="end_to_end"))
    for w in bench["workloads"]:
        cell, config, traffic, per_layer, e2e = harness.cell_inputs(bench, w["name"])
        assert traffic["entry"] in __import__("benchmark.drives", fromlist=["ENTRIES"]).ENTRIES
        assert per_layer and {"setup_s"} < {m["name"] for m in e2e}


def test_a_reader_that_finds_nothing_returns_nothing():
    bench = harness.load_bench(ROOT)
    empty = SimpleNamespace(points=0, models=0, calls=0, window_s=0.0, busy_s=0.0, kernels=0, span_device_s={},
                            least_ms={}, wall_s={}, factorize=[])
    for m in bench["per_layer"]:
        assert harness.layer_reader(m["name"])(empty) is None

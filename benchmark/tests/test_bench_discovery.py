"""A configuration, a traffic mix, a kind of call or a per-layer metric that
a later change adds as new files beside the others is found by its name in
``BENCHMARK.json``, with no file of the harness edited: also a geometry
given by its vertices with transport terminals, and a cell on several
cards whose traffic splits each call over data rows."""

import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import drives, harness

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
        assert issubclass(harness.entry_class(traffic["entry"]), drives.Entry)
        assert per_layer and {"setup_s"} < {m["name"] for m in e2e}


def test_a_reader_that_finds_nothing_returns_nothing():
    bench = harness.load_bench(ROOT)
    empty = SimpleNamespace(points=0, models=0, calls=0, window_s=0.0, busy_s=0.0, kernels=0, span_device_s={},
                            least_ms={}, wall_s={}, factorize=[])
    for m in bench["per_layer"]:
        assert harness.layer_reader(m["name"])(empty) is None


#: A kind of call that no cell has: a bias sweep through a strip's
#: transport terminals, split over data rows when the traffic says so.
BIAS_SWEEP = """
import numpy as np

from benchmark.devices import build_device
from benchmark.drives import Check, Entry


class BiasSweep(Entry):
    def setup(self, st):
        self.st = st
        c = self.config
        self.device = build_device(st, "strip", c["devices"]["strip"], c["solve_dtype"])
        self.model = st.factorize_model(device=self.device, current_units="uA", torch_device=self.torch_device)
        if self.traffic.get("data_rows"):
            from superscreen_tpu_torch.parallel import batch_sharding, make_mesh

            self.sharding = batch_sharding(make_mesh(n_data=self.traffic["data_rows"], devices=self.cards))

    def points(self, params):
        return len(params)

    def draw(self, rng):
        return self.uniform(rng, "bias_uA", self.traffic["points_per_call"])

    def call(self, params):
        result = self.st.solve_many(
            model=self.model, applied_fields=[self.st.sources.ConstantField(0)] * len(params),
            terminal_currents=[{"strip": {"source": float(b), "drain": -float(b)}} for b in params],
            sharding=self.sharding, torch_device=self.torch_device,
        )
        return np.array(result.streams["strip"])

    def check(self, kept, device):
        # With no applied field the streams are linear in the bias.
        worst = 0.0
        for bias, g in kept:
            unit = g / np.asarray(bias)[:, None]
            worst = max(worst, float(np.abs(unit - unit[0]).max() / np.abs(unit[0]).max()))
        return [Check("linearity", worst, self.config["limits"]["linearity"])]


ENTRY = BiasSweep
"""


def _box(width, height, points, x0=0.0):
    import superscreen_tpu_torch as st

    return (st.geometry.box(width, height, points=points) + [x0, 0.0]).tolist()


def test_a_new_kind_of_call_on_a_new_geometry_over_four_cards_runs_from_new_files(tmp_path):
    import superscreen_tpu_torch as st

    from benchmark.devices import build_device, sha256

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("data", "__pycache__"))
    spec = {
        "length_units": "um",
        "layers": [{"name": "base", "Lambda": 1.0, "z0": 0.0}],
        "films": [{
            "name": "strip", "layer": "base", "points": _box(4, 2, 40),
            "terminals": [{"name": "source", "points": _box(0.2, 2, 16, -2.0)},
                          {"name": "drain", "points": _box(0.2, 2, 16, 2.0)}],
        }],
        "mesh": {"max_edge_length": 0.5},
        "files": {},
    }
    device = build_device(st, "strip", spec, "float64", meshed=False)
    device.make_mesh(**spec["mesh"])
    mesh = tmp_path / "strip.npz"
    np.savez_compressed(mesh, sites=device.meshes["strip"].sites, elements=device.meshes["strip"].elements)
    spec["files"]["strip"] = {"file": str(mesh), "sha256": sha256(mesh)}
    config = {"name": "strip", "solve_dtype": "float64", "devices": {"strip": spec}, "reduced": [],
              "limits": {"linearity": 1e-8}}
    (tmp_path / "benchmark/configs/strip.json").write_text(json.dumps(config))
    (tmp_path / "benchmark/entries/bias_sweep.py").write_text(BIAS_SWEEP)
    (tmp_path / "benchmark/traffic/bias8.json").write_text(json.dumps(
        {"entry": "bias_sweep", "points_per_call": 8, "bias_uA": [1.0, 5.0], "data_rows": 4,
         "warm_calls": 1, "check_calls": 2}
    ))
    bench = harness.load_bench(ROOT)
    bench["configs"].append({"name": "strip", "source": "x", "file": "benchmark/configs/strip.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "strip_bias", "config": "strip", "traffic": "bias8", "chips": 4, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("strip_bias")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell, cfg, traffic, per_layer, e2e = harness.cell_inputs(harness.load_bench(tmp_path), "strip_bias", tmp_path)
    assert traffic["data_rows"] == 4 and cfg["devices"]["strip"]["films"][0]["terminals"][1]["name"] == "drain"
    built = build_device(st, "strip", cfg["devices"]["strip"], cfg["solve_dtype"])
    assert [t.name for t in built.terminals["strip"]] == ["source", "drain"]
    outline = st.Polygon("strip", layer="base", points=np.asarray(spec["films"][0]["points"]))
    np.testing.assert_array_equal(built.films["strip"].points, outline.points)
    result, failures, found, _ = harness.run_cell(
        cell, cfg, traffic, per_layer, e2e, 2**31 + 3, 0.3, 0, "cpu", time.perf_counter(), root=tmp_path
    )
    assert not failures and not found
    assert result["correct"] is True and result["device"]["count"] == 4
    assert result["attempted"] >= 1 and set(result["metrics"]) == {"ms_per_point", "setup_s"}
    assert result["checks"]["linearity"]["value"] <= 1e-8

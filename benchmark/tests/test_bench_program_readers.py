"""The readers of the program's own spans and counters
(``superscreen_tpu_torch.tracing.snapshot()``), on a hand-made snapshot and
context, and on a program that has no such module."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import harness

MS = 1_000_000  # ns


def _span(name, start_ms, end_ms):
    from superscreen_tpu_torch.tracing import Span

    return Span(name, start_ms * MS, None if end_ms is None else end_ms * MS, None, 0)


SNAPSHOT = {
    "spans": [
        _span("solve_many", 0, 100),
        _span("sweep.inputs", 1, 4),
        _span("sweep.results", 60, 90),
        _span("sweep.to_host", 60, 70),
        _span("sweep.results", 150, 160),
        _span("scan.readout", 95, 99),
        _span("scan.readout", 200, 205),
        _span("sweep.results", 300, None),  # still open: not counted
    ],
    "counters": {"d2h_bytes": 3_000_000, "h2d_bytes": 1_000_000, "host_syncs": 20},
    "launches": {}, "cg": {}, "native": {},
}


@pytest.fixture
def snapshot(monkeypatch):
    from superscreen_tpu_torch import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: SNAPSHOT)


@pytest.mark.parametrize(
    "name, value",
    [
        ("results_ms.point", 40 / 8),
        ("inputs_ms.point", 3 / 8),
        ("copy_mb.point", 4.0 / 8),
        ("syncs.point", 20 / 8),
        ("results_ms.scan", 40 / 8),
        ("readout_ms.scan", 9 / 8),
        ("copy_mb.scan", 4.0 / 8),
    ],
)
def test_reader_on_a_made_up_snapshot(snapshot, name, value):
    ctx = SimpleNamespace(points=8, models=0, calls=2, window_s=1.0)
    assert harness.layer_reader(name)(ctx) == pytest.approx(value)
    assert harness.layer_reader(name)(SimpleNamespace(points=0, models=0, calls=0, window_s=0.0)) is None


READERS = ["results_ms.point", "inputs_ms.point", "copy_mb.point", "syncs.point",
           "results_ms.scan", "readout_ms.scan", "copy_mb.scan"]


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_snapshot(monkeypatch, name):
    from superscreen_tpu_torch import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": [], "counters": {}})
    assert harness.layer_reader(name)(SimpleNamespace(points=8, calls=1)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_tracing_returns_nothing(monkeypatch, name):
    import superscreen_tpu_torch

    monkeypatch.delattr(superscreen_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "superscreen_tpu_torch.tracing", None)
    assert harness.layer_reader(name)(SimpleNamespace(points=8, calls=1)) is None


def test_every_new_reader_is_in_the_benchmark_for_its_cells():
    bench = harness.load_bench()
    cells = {m["name"]: m.get("workloads") for m in bench["per_layer"]}
    for name in READERS:
        want = ["scan64"] if name.endswith(".scan") else ["rings27k_sweep", "rings27k_solve", "rings27k_sweep_4chip"]
        assert cells[name] == want

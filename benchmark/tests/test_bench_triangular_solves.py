"""The reader of ``triangular_solves.point``: the program's solves on packed
LU factors per point, 0 where every film solves by a product, and nothing
where the program has no such counter."""

from types import SimpleNamespace

import pytest

from benchmark import harness


def test_the_triangular_solves_reader_on_made_up_snapshots(monkeypatch):
    from superscreen_tpu_torch import tracing

    read = harness.layer_reader("triangular_solves.point")
    ctx = SimpleNamespace(points=16, calls=2)
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": [], "counters": {"triangular_solves": 24}})
    assert read(ctx) == pytest.approx(1.5)
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": [], "counters": {"host_syncs": 3}})
    assert read(ctx) == 0
    assert read(SimpleNamespace(points=0, calls=0)) is None
    monkeypatch.delattr(tracing, "TRIANGULAR_SOLVES")
    assert read(ctx) is None


def test_the_reader_is_in_the_benchmark_for_the_transport_cell():
    metric = next(m for m in harness.load_bench()["per_layer"] if m["name"] == "triangular_solves.point")
    assert metric["workloads"] == ["transport_sweep"] and metric["layer"] == "sweep film solve"
    assert metric["moves"] == "ms_per_point" and metric["source"] == "program_counter"

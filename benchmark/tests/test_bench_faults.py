"""A run driven past the look for a card, at a size a CPU holds, with the
timed path broken underneath, comes out not correct; the same run with the
path sound comes out correct.  The faults: an answer altered where it is
produced, half of the batch left out and the mean of the rest put in its
place, a coupling round that returns no field (the state unchanged), and,
in the cell on four cards (rehearsed here over four CPU slots), the data
rows' results left ungathered."""

import importlib
import time

import numpy as np
import pytest
import torch

from benchmark import harness

CELLS = {"rings27k_sweep": "four_ring_27k", "rings27k_solve": "four_ring_27k",
         "rings27k_refactor": "four_ring_27k", "scan64": "scan_config5",
         "rings27k_sweep_4chip": "four_ring_27k"}


def run(small, workload, seconds=0.6):
    bench = harness.load_bench()
    cell, _, traffic, per_layer, e2e = harness.cell_inputs(bench, workload)
    config = small(CELLS[workload])
    result, failures, found, _ = harness.run_cell(
        cell, config, traffic, per_layer, e2e, 2**31 + 77, seconds, 0, "cpu", time.perf_counter()
    )
    assert not found
    return result


def altered_streams(monkeypatch):
    from superscreen_tpu_torch import sweep

    solve = importlib.import_module("superscreen_tpu_torch.solver.solve")  # the module, not the function
    # Where each entry looks the runner up: solve_many in sweep, solve in
    # solver.solve.
    for module, name in ((sweep, "_run_sweep"), (solve, "_run_sweep_history")):
        fn = getattr(module, name)

        def broken(*args, _fn=fn, **kwargs):
            streams, Js, selfs, others = _fn(*args, **kwargs)
            first = next(iter(streams))
            g = streams[first]
            g[..., g.shape[-1] // 2] += 0.1 * g.abs().max()
            return streams, Js, selfs, others

        monkeypatch.setattr(module, name, broken)


def altered_flux(monkeypatch):
    from superscreen_tpu_torch.squids import scanning

    fn = scanning._contour_flux

    def broken(*args, **kwargs):
        flux = fn(*args, **kwargs)
        flux[len(flux) // 2] *= 1.05
        return flux

    monkeypatch.setattr(scanning, "_contour_flux", broken)


def half_batch(monkeypatch):
    from superscreen_tpu_torch import sweep

    fn = sweep._run_sweep

    def broken(film_data, Hz_applied, I_circ, *args, **kwargs):
        B = next(iter(Hz_applied.values())).shape[0]
        h = max(B // 2, 1)
        outs = fn(film_data, {k: v[:h] for k, v in Hz_applied.items()},
                  {k: v[:h] for k, v in I_circ.items()}, *args, **kwargs)
        return tuple(
            {k: torch.cat([v, v.mean(dim=0, keepdim=True).expand(B - h, *v.shape[1:])]) for k, v in d.items()}
            for d in outs
        )

    monkeypatch.setattr(sweep, "_run_sweep", broken)


def no_coupling(monkeypatch):
    from superscreen_tpu_torch import sweep

    def broken(film_data, films, streams, Js, Hz_applied, coupling="exact"):
        return {name: torch.zeros_like(Hz_applied[name]) for name in films}

    monkeypatch.setattr(sweep, "_coupling_round", broken)


def no_exchange(monkeypatch):
    """The exchange between the cards left out: the first card's buffer
    for each row's results is never filled (zeros where rows after the
    first would land)."""
    from superscreen_tpu_torch import sweep

    fn = sweep._run_data_rows

    def broken(runner, film_data, Hz_applied, I_circ, *args, batch_axis=0, **kwargs):
        outs = fn(runner, film_data, Hz_applied, I_circ, *args, batch_axis=batch_axis, **kwargs)
        B = next(iter(Hz_applied.values())).shape[0]
        first = -(-B // film_data.mesh.shape["data"])

        def only_first(v):
            v = v.clone()
            v.narrow(batch_axis, first, v.shape[batch_axis] - first).zero_()
            return v

        return tuple({k: only_first(v) for k, v in d.items()} for d in outs)

    monkeypatch.setattr(sweep, "_run_data_rows", broken)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_sound_run_is_correct(small, workload):
    result = run(small, workload)
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize(
    "workload, fault",
    [
        ("rings27k_sweep", altered_streams), ("rings27k_sweep", half_batch), ("rings27k_sweep", no_coupling),
        ("rings27k_solve", altered_streams), ("rings27k_solve", no_coupling),
        ("rings27k_refactor", altered_streams), ("rings27k_refactor", half_batch),
        ("rings27k_refactor", no_coupling),
        ("scan64", altered_flux), ("scan64", half_batch),
        ("rings27k_sweep_4chip", altered_streams), ("rings27k_sweep_4chip", half_batch),
        ("rings27k_sweep_4chip", no_coupling), ("rings27k_sweep_4chip", no_exchange),
    ],
    ids=lambda x: getattr(x, "__name__", x),
)
def test_a_broken_path_is_not_correct(small, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(small, workload)
    assert result["correct"] is False
    (check,) = result["checks"].values()
    assert check["value"] > check["limit"]

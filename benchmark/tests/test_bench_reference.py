"""The plain reference against the program on the CPU in float64, on a few
hundred sites of each configuration's geometry: the reference works every
operator out again from the mesh and the configuration."""

import numpy as np

import superscreen_tpu_torch as st

from benchmark import harness
from benchmark.reference import films as ref


def test_stack_reference_meets_the_program(small):
    cfg = small("four_ring_27k", "float64")
    entry = harness.entry_class("solve_many")(cfg, {"points_per_call": 3, "field_mT": [0.1, 1.0]}, ["cpu"])
    entry.setup(st)
    fields = [0.13, 0.5, 0.97]
    out = entry.call(fields)
    basis = entry.reference_basis()
    assert entry.stream_error(out, fields, basis) < 1e-12


def test_refactored_stack_reference_meets_the_program(small):
    cfg = small("four_ring_27k", "float64")
    entry = harness.entry_class("refactor_sweep")(cfg, {"points_per_call": 2, "field_mT": [0.1, 1.0], "lambda_scale": [0.8, 1.2]}, ["cpu"])
    entry.setup(st)
    params = entry.draw(np.random.default_rng(5))
    out = entry.call(params)
    assert entry.stream_error(out, params[1], entry.reference_basis(params[0])) < 1e-12


def test_solve_reference_meets_the_program(small):
    cfg = small("four_ring_27k", "float64")
    entry = harness.entry_class("solve")(cfg, {"field_mT": [0.1, 1.0]}, ["cpu"])
    entry.setup(st)
    out = entry.call([0.42])
    assert entry.stream_error(out, [0.42], entry.reference_basis()) < 1e-12


def test_scan_reference_meets_the_program(small):
    cfg = small("scan_config5", "float64")
    entry = harness.entry_class("susceptibility_scan")(cfg, {"positions": 12, "x_um": [-8.0, 8.0], "y_um": [-2.0, 2.0]}, ["cpu"])
    entry.setup(st)
    M = entry.call(0.7)
    (want,) = entry.reference_scan([0.7], ref.F64, "cpu")
    assert entry.scan_error(M, want) < 1e-12


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch

    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10 + 2**-12, -3.0], dtype=torch.float32)
    assert ref.tf32(x).tolist() == [1.0, 1.0 + 2**-9, 1.0 + 2**-10, -3.0]

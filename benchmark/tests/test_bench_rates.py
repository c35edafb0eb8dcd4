"""The copied yardstick (:mod:`benchmark.rates`) at the shapes of PERF.md's
kernel table: the arithmetic, not a target."""

import pytest

from benchmark import rates


@pytest.mark.parametrize(
    "n, cols, ms, what",
    [(27298, 8, 0.468, "float32"), (27298, 1, 0.178, "rsqrt"), (20274, 1, 0.098, "rsqrt")],
)
def test_biot_savart_batch_bound(n, cols, ms, what):
    bound, by = rates.pairwise_bound("biot_savart_batch", "float32", n, n, cols)
    assert by == what
    assert bound == pytest.approx(ms, abs=5e-4)


def test_residual_bound_at_one_column():
    bound, by = rates.residual_bound(16768, 16768, 1)
    assert by == "bytes"
    assert bound == pytest.approx(0.336, abs=5e-4)


def test_residual_bound_turns_to_operations():
    # At k = 64 on config 5's sample (PERF.md: 0.086 ms, FP64 tensor).
    bound, by = rates.residual_bound(6715, 6715, 64)
    assert by == "float64_tensor"
    assert bound == pytest.approx(0.086, abs=5e-4)


def test_apply_bound_reads_the_operator_once():
    bound, by = rates.apply_bound(16768, 8)
    assert by == "bytes"
    assert bound == pytest.approx(4 * 16768**2 / 3.35e12 * 1e3, rel=1e-3)


def test_card_limits_reads_nothing_without_a_card(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert rates.card_limits() == "not read"

"""The arithmetic of the end-to-end metrics, the sample of calls that the
check reads, and the look for JAX among the loaded modules."""

import numpy as np
import pytest

from benchmark import drives, harness


def window(**kw):
    from types import SimpleNamespace

    base = dict(latencies=[0.1, 0.2, 0.3], points=24, models=0, window_s=0.6, setup_s=12.5)
    return SimpleNamespace(**{**base, **kw})


def e2e(name, w):
    return harness.layer_reader(name, kind="end_to_end")(w)


def test_window_rate_is_all_time_over_all_points():
    assert e2e("ms_per_point", window()) == pytest.approx(25.0)
    assert e2e("ms_per_position", window()) == pytest.approx(25.0)
    assert e2e("ms_per_model", window()) is None
    assert e2e("setup_s", window()) == 12.5


def test_window_rate_per_model():
    assert e2e("ms_per_model", window(latencies=[1.0, 1.5], points=16, models=2, window_s=2.6)) == pytest.approx(1300.0)


def test_p95_covers_every_call():
    calls = [0.010] * 95 + [0.100] * 5
    # The tail of all calls: the five slow ones are in it.
    assert e2e("call_p95_ms", window(latencies=calls)) == pytest.approx(14.5)
    assert e2e("scan_p95_ms", window(latencies=calls)) == pytest.approx(14.5)
    assert harness.p95(list(range(1, 101))) == pytest.approx(np.percentile(np.arange(1, 101), 95))


def test_reservoir_is_a_seeded_uniform_sample():
    def sample(seed):
        r = drives.Reservoir(4, seed)
        for i in range(100):
            r.offer(i)
        return r.items

    assert sample(7) == sample(7)
    assert sample(7) != sample(8)
    assert len(sample(7)) == 4
    short = drives.Reservoir(4, 1)
    for i in range(3):
        short.offer(i)
    assert short.items == [0, 1, 2]


@pytest.mark.parametrize(
    "names, found",
    [
        (["jax"], ["jax"]),
        (["jax.numpy", "numpy"], ["jax.numpy"]),
        (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
        (["flax.linen"], ["flax.linen"]),
        (["superscreen_tpu", "superscreen_tpu.solver"], ["superscreen_tpu", "superscreen_tpu.solver"]),
        (["superscreen_tpu_torch", "superscreen_tpu_torch.sweep", "jaxtyping", "jax_like"], []),
    ],
)
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_check_needs_a_finite_value_within_the_limit():
    assert drives.Check("x", 1e-5, 1e-4).ok
    assert not drives.Check("x", 2e-4, 1e-4).ok
    assert not drives.Check("x", float("nan"), 1e-4).ok


def test_trace_reduction_on_a_made_up_timeline():
    from benchmark import trace

    device = [(0.0, 1.0, "k1", 0), (0.5, 2.0, "k2", 0), (3.0, 4.0, "Memcpy DtoH", 0), (6.0, 7.0, "k1", 0)]
    annotations = [(0.0, 2.0, "bench.a", 0), (2.5, 7.5, "bench.b", 0)]
    cpu = [(0.0, 8.0, "call"), (1.5, 3.5, "bench.b"), (2.0, 2.9, "aten::copy_"), (4.5, 5.5, "aten::item")]
    t = trace.reduce_events(device, annotations, cpu)
    assert t.busy_s == 4.0 and t.kernels == 3
    assert t.span_device_s == {"bench.a": 2.0, "bench.b": 2.0}
    assert t.device_ops[0] == ["k1", 2.0]
    # Gaps: 2-3 (the host in bench.b's copy), 4-6 (in call).
    assert dict(t.idle_gaps) == {"bench.b > aten::copy_": 1.0, "call": 2.0}


def test_trace_reduction_per_card_on_two_devices():
    from benchmark import trace

    device = [(0.0, 1.0, "k1", 0), (0.5, 2.0, "k2", 0), (0.0, 1.0, "k1", 1), (3.0, 4.0, "Memcpy PtoP", 1)]
    # bench.a runs 0-2 on card 0 and 0-4 on card 1; bench.b is a range on
    # card 1 only, over an interval in which card 0 alone is busy.
    annotations = [(0.0, 2.0, "bench.a", 0), (0.0, 4.0, "bench.a", 1), (1.2, 2.0, "bench.b", 1)]
    cpu = [(0.0, 8.0, "call"), (1.5, 3.5, "aten::copy_")]
    t = trace.reduce_events(device, annotations, cpu, cards=[0, 1, 2])
    # Card 2 ran nothing: idle all the window, and in the mean.
    assert t.busy_s_per_card == [2.0, 2.0, 0.0] and t.busy_s == pytest.approx(4 / 3)
    assert t.kernels == 3
    assert t.span_device_s == {"bench.a": 4.0, "bench.b": 0.0}
    assert dict(t.device_ops) == pytest.approx({"k1": 2 / 3, "k2": 0.5, "Memcpy PtoP": 1 / 3})
    # Card 1's gap 1-3 began while the host was in "call"; card 0 has none.
    assert dict(t.idle_gaps) == pytest.approx({"call": 2 / 3})
    # Without cards, the cards are those that ran something.
    one = trace.reduce_events([e for e in device if e[3] == 1], annotations, cpu)
    assert one.busy_s_per_card == [2.0] and one.busy_s == 2.0 and one.span_device_s["bench.a"] == 2.0

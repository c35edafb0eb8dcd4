"""The kinds of call under ``benchmark/entries``: the four that the cells use
draw the same parameters from a seed and give results of the same shapes
as they did before they moved into files of their own, and ``solve_many``
over four data rows gives the streams of the call on one device."""

import numpy as np
import pytest

import superscreen_tpu_torch as st

from benchmark import drives, harness

SEED = 2**31 + 11
CONFIGS = {"rings27k_sweep": "four_ring_27k", "rings27k_solve": "four_ring_27k",
           "rings27k_refactor": "four_ring_27k", "scan64": "scan_config5"}

#: The first two draws of each cell's window at SEED, as ``drives.ENTRIES``
#: drew them before the kinds of call moved into ``benchmark/entries``.
PINNED = {
    "rings27k_sweep": [
        [0.893708553066139, 0.30131331518607096, 0.17705871205807394, 0.6551132550417644,
         0.9498195811239311, 0.1777339475819013, 0.45720443149494217, 0.4183649134419457],
        [0.982231437828251, 0.5171408284310511, 0.11118951267970135, 0.46659903259644053,
         0.39201748132937675, 0.9953422833499919, 0.258525229549999, 0.2532059154804175],
    ],
    "rings27k_solve": [[0.893708553066139], [0.30131331518607096]],
    "rings27k_refactor": [
        ({"layer0": 0.576379678459142, "layer1": 0.6671044383953569, "layer2": 0.8342483164702551,
          "layer3": 1.3083962528009803},
         [0.9498195811239311, 0.1777339475819013, 0.45720443149494217, 0.4183649134419457,
          0.982231437828251, 0.5171408284310511, 0.11118951267970135, 0.46659903259644053]),
        ({"layer0": 0.46489277362875037, "layer1": 0.8984474277833306, "layer2": 0.8704556575777773,
          "layer3": 1.0851143974891209},
         [0.9957675894524711, 0.8926818296911483, 0.749930232256087, 0.7416451258467454,
          0.2711577607655037, 0.6700895004130166, 0.37702058456892173, 0.27101850332111826]),
    ],
    "scan64": [1.5275935691828404, -1.1052741547285736],
}


def entry_of(workload, config, cards=("cpu",)):
    _, _, traffic, _, _ = harness.cell_inputs(harness.load_bench(), workload)
    return harness.entry_class(traffic["entry"])(config, traffic, cards)


def test_the_kinds_of_call_are_files_found_by_name():
    names = sorted(p.stem for p in (harness.ROOT / "benchmark" / "entries").glob("*.py"))
    assert names == ["refactor_sweep", "solve", "solve_many", "susceptibility_scan"]
    for name in names:
        assert issubclass(harness.entry_class(name), drives.Entry)
    with pytest.raises(FileNotFoundError):
        harness.entry_class("no_such_call")


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_the_draws_are_pinned(workload):
    entry = entry_of(workload, harness.cell_inputs(harness.load_bench(), workload)[1])
    rng = np.random.default_rng([SEED, 0])
    for want in PINNED[workload]:
        got = entry.draw(rng)
        if workload == "rings27k_refactor":
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
        elif workload == "scan64":
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_a_call_gives_the_pinned_shapes(small, workload):
    config = small(CONFIGS[workload])
    entry = entry_of(workload, config)
    entry.setup(st)
    params = entry.draw(np.random.default_rng([SEED, 0]))
    out = entry.call(params)
    if workload == "scan64":
        assert entry.points(params) == 64 and out.shape == (64,)
        return
    points = {"rings27k_sweep": 8, "rings27k_solve": 1, "rings27k_refactor": 8}[workload]
    assert entry.points(params) == points
    sites = {f: len(np.load(spec["file"])["sites"]) for f, spec in config["devices"]["stack"]["files"].items()}
    assert {name: g.shape for name, g in out.items()} == {f: (points, n) for f, n in sites.items()}


def test_solve_many_over_four_data_rows_gives_the_streams_of_one_device(small):
    config = small("four_ring_27k")
    traffic = {"entry": "solve_many", "points_per_call": 32, "field_mT": [0.1, 1.0], "data_rows": 4}
    cls = harness.entry_class("solve_many")
    rows = cls(config, traffic, ["cpu"] * 4)
    one = cls(config, {k: v for k, v in traffic.items() if k != "data_rows"}, ["cpu"])
    rows.setup(st)
    one.setup(st)
    assert rows.sharding.mesh.shape == {"data": 4, "model": 1} and one.sharding is None
    fields = rows.draw(np.random.default_rng([SEED, 0]))
    got, want = rows.call(fields), one.call(fields)
    assert {k: g.shape for k, g in got.items()} == {k: g.shape for k, g in want.items()}
    gap = max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want)
    # Float32 on one host: the rows' sums differ from the whole batch's at
    # most in their last bits, far inside the stack's limit.
    assert gap <= 1e-5 < config["limits"]["stream_rel_err"]
    assert rows.stream_error(got, fields, rows.reference_basis()) <= config["limits"]["stream_rel_err"]

"""The frozen meshes: every file matches the sha256 its configuration
records, and a device meshed directly solves to the same streams when its
mesh is written out and read back through ``Mesh.from_triangulation``."""

import json
from pathlib import Path

import numpy as np
import pytest

import superscreen_tpu_torch as st

from benchmark import devices

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_each_frozen_file_matches_its_hash(path):
    config = json.loads(path.read_text())
    for spec in config["devices"].values():
        for film in spec["films"]:
            entry = spec["files"][film["name"]]
            sites, elements = devices.frozen_mesh(entry)
            assert sites.dtype == np.float64 and elements.dtype == np.int32
            assert (len(sites), len(elements)) == (entry["sites"], entry["elements"])


def test_a_changed_file_is_refused(tmp_path):
    path = tmp_path / "m.npz"
    np.savez_compressed(path, sites=np.zeros((3, 2)), elements=np.zeros((1, 3), dtype=np.int32))
    entry = {"file": str(path), "sha256": "0" * 64}
    with pytest.raises(ValueError, match="sha256"):
        devices.frozen_mesh(entry)


def test_reloaded_mesh_solves_as_the_meshed_one(small):
    cfg = small("four_ring_27k")
    spec = cfg["devices"]["stack"]
    meshed = devices.build_device(st, "stack", spec, "float32", meshed=False)
    meshed.make_mesh(**{**spec["mesh"], "min_points": 300})
    loaded = devices.build_device(st, "stack", spec, "float32")
    streams = []
    for device in (meshed, loaded):
        model = st.factorize_model(device=device, current_units="uA", circulating_currents={"hole0": 1000.0},
                                   torch_device="cpu")
        result = st.solve_many(model=model, applied_fields=[st.sources.ConstantField(0.4)], iterations=2,
                               coupling="exact", torch_device="cpu")
        streams.append(result.streams)
    for name in meshed.films:
        np.testing.assert_array_equal(meshed.meshes[name].sites, loaded.meshes[name].sites)
        np.testing.assert_array_equal(streams[0][name], streams[1][name])

"""Shared pieces of the benchmark's CPU tests: small copies of each
configuration, meshed directly by the program at a few hundred sites per
film (the frozen full-size meshes are for the card)."""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

#: Sites per film of the small copies.
SMALL = {"four_ring_27k": {"stack": 300}, "scan_config5": {"squid": 250, "sample": 400}}


def config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def small_config(name: str, out_dir: Path, dtype: str = None) -> dict:
    """The configuration ``name`` with each device meshed by the program at
    :data:`SMALL`'s size, its mesh files written under ``out_dir``."""
    import superscreen_tpu_torch as st

    from benchmark.devices import build_device, sha256

    cfg = copy.deepcopy(config(name))
    if dtype:
        cfg["solve_dtype"] = dtype
    for dev_name, spec in cfg["devices"].items():
        device = build_device(st, dev_name, spec, cfg["solve_dtype"], meshed=False)
        device.make_mesh(**{**spec["mesh"], "min_points": SMALL[name][dev_name]})
        for film, mesh in device.meshes.items():
            path = out_dir / f"{name}_{film}.npz"
            np.savez_compressed(path, sites=mesh.sites, elements=mesh.elements.astype(np.int32))
            spec["files"][film] = {"file": str(path), "sha256": sha256(path)}
    return cfg


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """``small(name, dtype=None)``: a cached small copy of a configuration."""
    out = tmp_path_factory.mktemp("meshes")
    cache = {}

    def get(name, dtype=None):
        if (name, dtype) not in cache:
            d = out / f"{name}_{dtype}"
            d.mkdir()
            cache[name, dtype] = small_config(name, d, dtype)
        return cache[name, dtype]

    return get

"""The port's provenance (``about``, ``version``), ``testing.run`` and its
top-level API against the JAX package's: every public name of
``superscreen_tpu`` and of its classes has a counterpart in the port, but
for the modules ROADMAP names as left out."""

import importlib
import subprocess

import pytest

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu_torch import about, testing

# Left out of the port (ROADMAP): by design, the JAX package's
# compile-statistics counter.
LEFT_OUT = {
    "solver.solve_film": {"FACTORIZE_STATS"},
}
MODULES = [
    "about", "distance", "fem", "io", "testing", "version", "visualization",
    "device.mesh_cache", "device.mesh_generation", "solver", "solver.solve",
    "solver.solve_film", "solver.utils", "native", "ops", "parallel", "parallel.sharding",
]


def _public(obj):
    return {
        name for name in dir(obj)
        if not name.startswith("_") and not isinstance(getattr(obj, name, None), type(importlib))
    }


def test_version_dict_reports_torch_and_the_card():
    info = about.version_dict()
    assert info["superscreen_tpu_torch"] == st.__version__ == "0.1.0"
    assert st.__version_info__ == (0, 1, 0)
    for key in ("python", "OS", "machine", "torch", "numpy", "scipy", "matplotlib", "h5py",
                "torch_cuda", "cuda_devices", "cuda_device_count"):
        assert isinstance(info[key], str), key
    assert "jax" not in info
    assert st.version_dict is about.version_dict


@pytest.mark.parametrize("verbose", [False, True])
def test_version_table(verbose):
    table = st.version_table(verbose=verbose)
    html = str(getattr(table, "data", table))
    assert html.startswith("<table>") and "superscreen_tpu_torch" in html
    assert ("<td>OS</td>" in html) == verbose


def test_solutions_embed_the_version_dict():
    ring = st.Polygon("ring", layer="base", points=st.geometry.circle(2, points=30))
    device = st.Device("d", layers=[st.Layer("base", Lambda=1.0)], films=[ring])
    device.make_mesh(max_edge_length=0.8)
    solution = st.solve(device, torch_device="cpu", progress_bar=False)[-1]
    assert solution.version_info.keys() == about.version_dict().keys()


def test_testing_run_collects_the_port_tests(monkeypatch):
    seen = {}

    def call(args, env):
        seen.update(args=args, env=env)
        return 0

    monkeypatch.setattr(subprocess, "call", call)
    assert testing.run() == 0
    files = [a for a in seen["args"] if a.endswith(".py")]
    assert files and all("test_torch_" in f for f in files)
    assert any(f.endswith("test_torch_about.py") for f in files)
    assert seen["env"]["MPLBACKEND"] == "Agg"


def test_top_level_names_match_the_reference():
    assert _public(sc) - _public(st) == set()
    for name in st.__all__:
        assert hasattr(st, name), name


@pytest.mark.parametrize("cls", [
    "Device", "Polygon", "Layer", "Mesh", "MeshOperators", "EdgeMesh", "Solution",
    "FilmSolution", "Vortex", "FactorizedModel", "CompositeParameter", "Parameter",
])
def test_class_names_match_the_reference(cls):
    assert _public(getattr(sc, cls)) - _public(getattr(st, cls)) == set()


@pytest.mark.parametrize("module", MODULES)
def test_module_names_match_the_reference(module):
    ref = importlib.import_module(f"superscreen_tpu.{module}")
    port = importlib.import_module(f"superscreen_tpu_torch.{module}")
    names = set(getattr(ref, "__all__", ())) or {
        n for n in _public(ref) if getattr(getattr(ref, n), "__module__", None) == ref.__name__
    }
    assert names - _public(port) - LEFT_OUT.get(module, set()) == set()

"""The port's mesh cache against the JAX package's: the same key for the
same inputs, entries written by either package read by the other with
identical arrays, a corrupt entry treated as a miss, and
``Device.make_mesh`` storing on a miss and hitting afterwards (also for
a mirrored device, whose films have the same outlines)."""

import os

import numpy as np
import pytest

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu.device import mesh_cache as ref_cache
from superscreen_tpu_torch.device import mesh_cache

ENV = "SUPERSCREEN_TPU_MESH_CACHE"


def _device(pkg):
    layers = [pkg.Layer("base", Lambda=1.0, z0=0.0), pkg.Layer("top", Lambda=0.5, z0=1.0)]
    films = [
        pkg.Polygon("ring", layer="base", points=geo.circle(4, points=50)),
        pkg.Polygon("disk", layer="top", points=geo.circle(2.5, points=40)),
    ]
    holes = [pkg.Polygon("hole", layer="base", points=geo.circle(1.5, points=30))]
    return pkg.Device("cached", layers=layers, films=films, holes=holes)


CASES = {
    "plain": (geo.circle(3, points=20), [], dict(min_points=None, max_edge_length=0.5,
                                                 preserve_boundary=False, smooth=0,
                                                 extra="[]")),
    "rings": (geo.box(4, 3), [geo.circle(1, points=17), geo.box(0.5, center=(1.2, 0.8))],
              dict(min_points=300, max_edge_length=None, preserve_boundary=True, smooth=3,
                   extra="[]")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cache_key_matches_reference(case):
    outer, rings, params = CASES[case]
    assert mesh_cache.cache_key(outer, rings, params) == ref_cache.cache_key(outer, rings, params)
    changed = dict(params, smooth=params["smooth"] + 1)
    assert mesh_cache.cache_key(outer, rings, changed) != mesh_cache.cache_key(outer, rings, params)


@pytest.mark.parametrize("writer, reader", [(mesh_cache, ref_cache), (ref_cache, mesh_cache)])
def test_entries_cross_packages(tmp_path, monkeypatch, writer, reader):
    monkeypatch.setenv(ENV, str(tmp_path))
    rng = np.random.default_rng(0)
    points = rng.uniform(-1, 1, (50, 2))
    triangles = rng.integers(0, 50, (70, 3))
    key = writer.cache_key(*CASES["rings"])
    assert reader.load(key) is None
    writer.store(key, points, triangles)
    loaded = reader.load(key)
    np.testing.assert_array_equal(loaded[0], points)
    np.testing.assert_array_equal(loaded[1], triangles)
    assert loaded[0].dtype == np.float64 and loaded[1].dtype == np.int64


@pytest.mark.parametrize("corruption", ["bytes", "bad_shape", "bad_index"])
def test_corrupt_entry_is_a_miss(tmp_path, monkeypatch, corruption):
    monkeypatch.setenv(ENV, str(tmp_path))
    key = mesh_cache.cache_key(*CASES["plain"])
    path = os.path.join(tmp_path, f"{key}.npz")
    if corruption == "bytes":
        with open(path, "wb") as f:
            f.write(b"not an npz file")
    elif corruption == "bad_shape":
        np.savez(path, points=np.zeros((4, 3)), triangles=np.zeros((2, 3), dtype=np.int64))
    else:
        np.savez(path, points=np.zeros((4, 2)), triangles=np.full((2, 3), 9, dtype=np.int64))
    assert mesh_cache.load(key) is None
    assert ref_cache.load(key) is None


def test_cache_is_off_by_default(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert mesh_cache.cache_dir() is None
    assert mesh_cache.load("anything") is None
    mesh_cache.store("anything", np.zeros((3, 2)), np.zeros((1, 3), dtype=np.int64))


def test_make_mesh_stores_then_hits(tmp_path, monkeypatch):
    """A miss stores one entry per film; remeshing, and meshing the mirror
    image, hit with identical arrays (nothing new is stored); the JAX
    package finds the same entries for its device."""
    monkeypatch.setenv(ENV, str(tmp_path))
    device = _device(st)
    device.make_mesh(max_edge_length=0.6)
    stored = sorted(os.listdir(tmp_path))
    assert len(stored) == len(device.films)

    calls = []
    real = st.device.device.mgen.generate_mesh
    monkeypatch.setattr(
        st.device.device.mgen, "generate_mesh", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    for again in (_device(st), _device(st).mirror_layers()):
        again.make_mesh(max_edge_length=0.6)
        for name, mesh in device.meshes.items():
            np.testing.assert_array_equal(again.meshes[name].sites, mesh.sites)
            np.testing.assert_array_equal(again.meshes[name].elements, mesh.elements)
    assert not calls
    assert sorted(os.listdir(tmp_path)) == stored
    ref = _device(sc)
    ref.make_mesh(max_edge_length=0.6)
    for name, mesh in device.meshes.items():
        np.testing.assert_array_equal(ref.meshes[name].sites, mesh.sites)
    assert sorted(os.listdir(tmp_path)) == stored

"""HDF5 files of the port against the JAX package's, both ways, at float64
on the CPU: polygons, layers, meshes and devices written by one package
and read by the other; solutions written by either and read by the port;
the port's factorized models saved and reloaded (bitwise-equal streams)
and JAX float64 LU models loaded into the port (within 1e-12 of the JAX
``solve``); ``solve(save_path=...)``; and the ImportErrors without h5py,
dill or matplotlib.

The dill-pickled objects in these files (a ``Parameter`` penetration
depth, the applied-field callable of a Solution) are made with the
reading package's classes, so that each pickle names only the package
that reads it."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu.solver import utils as ref_utils

h5py = pytest.importorskip("h5py")
pytest.importorskip("dill")

torch.set_num_threads(2)

PACKAGES = {"jax": sc, "port": st}
DIRECTIONS = [("port", "jax"), ("jax", "port")]
# A JAX model loaded into the port is solved by the port: float64 on both
# sides, other summation orders.
MODEL_RTOL = 1e-12


def _weak_spot(x, y, depth=0.3):
    return 1.0 - depth * np.exp(-(x**2 + y**2))


def _layer(pkg, kind):
    if kind == "float":
        return pkg.Layer("base", Lambda=0.75, z0=0.5)
    if kind == "london":
        return pkg.Layer("base", london_lambda=0.2, thickness=0.05, z0=-1.0)
    return pkg.Layer("base", Lambda=pkg.Parameter(_weak_spot, depth=0.25), z0=1.5)


def _stack(pkg, solve_dtype="float64", terminals=False):
    """A ring with a hole under a disk with an abstract patch, meshed
    coarsely (the strip with two terminals when ``terminals``)."""
    if terminals:
        film = pkg.Polygon("strip", layer="base", points=geo.box(4, 2, points=40))
        src = pkg.Polygon("source", points=geo.box(0.2, 2, points=16, center=(-2, 0)))
        drain = pkg.Polygon("drain", points=geo.box(0.2, 2, points=16, center=(2, 0)))
        device = pkg.Device(
            "strip", layers=[pkg.Layer("base", Lambda=1)], films=[film],
            terminals={"strip": [src, drain]}, solve_dtype=solve_dtype,
        )
        device.make_mesh(max_edge_length=0.6)
        return device
    layers = [pkg.Layer("base", Lambda=1.0, z0=0), pkg.Layer("top", Lambda=0.5, z0=1.0)]
    films = [
        pkg.Polygon("ring", layer="base", points=geo.circle(5, points=60)),
        pkg.Polygon("disk", layer="top", points=geo.circle(3, points=40)),
    ]
    holes = [pkg.Polygon("hole", layer="base", points=geo.circle(2, points=30))]
    abstract = [pkg.Polygon("patch", layer="base", points=geo.box(1.0, center=(3.5, 0)))]
    device = pkg.Device(
        "stack", layers=layers, films=films, holes=holes, abstract_regions=abstract,
        solve_dtype=solve_dtype,
    )
    device.make_mesh(max_edge_length=0.9)
    return device


@pytest.fixture(scope="module")
def stacks():
    return {name: _stack(pkg) for name, pkg in PACKAGES.items()}


def _assert_meshes_equal(a, b, full):
    for name in ("sites", "elements") + (
        ("triangle_centroids", "boundary_indices", "vertex_areas", "triangle_areas")
        if full else ()
    ):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if full:
        for name in ("centers", "edges", "boundary_edge_indices", "directions", "edge_lengths"):
            np.testing.assert_array_equal(
                getattr(a.edge_mesh, name), getattr(b.edge_mesh, name)
            )


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
@pytest.mark.parametrize("kind", ["polygon", "float", "london", "parameter"])
def test_polygons_and_layers_cross_packages(tmp_path, writer, reader, kind):
    """Written by one package, read by the other, equal to the reader's own
    object (the ``Parameter`` is the reader's class, see the module
    docstring)."""
    if kind == "polygon":
        make = {
            name: (lambda pkg=pkg: pkg.Polygon("p", layer="l", points=geo.circle(2, points=33)))
            for name, pkg in PACKAGES.items()
        }
    elif kind == "parameter":
        theirs = _layer(PACKAGES[reader], kind)
        make = {
            reader: lambda: theirs,
            writer: lambda: PACKAGES[writer].Layer("base", Lambda=theirs.Lambda, z0=1.5),
        }
    else:
        make = {name: (lambda pkg=pkg: _layer(pkg, kind)) for name, pkg in PACKAGES.items()}
    cls = type(make[reader]())
    with h5py.File(tmp_path / "obj.h5", "w") as f:
        make[writer]().to_hdf5(f.create_group("obj"))
    with h5py.File(tmp_path / "obj.h5", "r") as f:
        loaded = cls.from_hdf5(f["obj"])
    assert type(loaded) is cls
    assert loaded == make[reader]()
    if kind == "polygon":
        np.testing.assert_array_equal(loaded.points, make[reader]().points)
    if kind == "parameter":
        xs = np.linspace(-1, 1, 7)
        np.testing.assert_array_equal(loaded.Lambda(xs, xs), theirs.Lambda(xs, xs))


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
@pytest.mark.parametrize("compress", [True, False])
def test_meshes_cross_packages(tmp_path, stacks, writer, reader, compress):
    """What one package wrote, the other reads to the same arrays (rebuilt
    from sites and elements when compressed)."""
    mesh = stacks[writer].meshes["ring"]
    with h5py.File(tmp_path / "mesh.h5", "w") as f:
        mesh.to_hdf5(f.create_group("mesh"), compress=compress)
    with h5py.File(tmp_path / "mesh.h5", "r") as f:
        assert PACKAGES[reader].Mesh.is_restorable(f["mesh"]) == (not compress)
        loaded = PACKAGES[reader].Mesh.from_hdf5(f["mesh"])
    _assert_meshes_equal(loaded, mesh, full=True)


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
@pytest.mark.parametrize("terminals", [False, True])
def test_devices_cross_packages(tmp_path, stacks, writer, reader, terminals):
    if terminals:
        devices = {name: _stack(pkg, terminals=True) for name, pkg in PACKAGES.items()}
    else:
        devices = stacks
    devices[writer].to_hdf5(tmp_path / "device.h5")
    loaded = PACKAGES[reader].Device.from_hdf5(tmp_path / "device.h5")
    assert loaded == devices[reader]
    assert loaded.solve_dtype == devices[reader].solve_dtype
    for name, mesh in devices[writer].meshes.items():
        _assert_meshes_equal(loaded.meshes[name], mesh, full=True)


def _port_solutions(device, **kwargs):
    return st.solve(
        device, applied_field=st.sources.ConstantField(0.3), circulating_currents={"hole": "2 uA"},
        iterations=2, coupling="exact", torch_device="cpu", progress_bar=False, **kwargs,
    )


def _assert_solutions_bitwise(a, b):
    # A file the JAX package wrote lists its groups alphabetically.
    assert sorted(a.film_solutions) == sorted(b.film_solutions)
    for name, fs in a.film_solutions.items():
        other = b.film_solutions[name]
        for key in ("stream", "current_density", "applied_field", "self_field", "total_field"):
            np.testing.assert_array_equal(getattr(fs, key), getattr(other, key))
        if fs.field_from_other_films is None:
            assert other.field_from_other_films is None
        else:
            np.testing.assert_array_equal(fs.field_from_other_films, other.field_from_other_films)


def test_port_solution_round_trip(tmp_path, stacks):
    solution = _port_solutions(stacks["port"])[-1]
    solution.to_hdf5(tmp_path / "solution.h5")
    loaded = st.Solution.from_hdf5(tmp_path / "solution.h5", torch_device="cpu")
    assert loaded.equals(solution)
    assert loaded == solution  # the timestamp too
    assert loaded.version_info == solution.version_info
    _assert_solutions_bitwise(loaded, solution)


def test_jax_solution_reads_in_port(tmp_path, stacks):
    """The JAX package's Solution, with the port's applied-field callable,
    read by the port: its arrays bitwise, and ``equals`` a port Solution
    made of them."""
    ref_device = stacks["jax"]
    ref = sc.solve(
        ref_device, applied_field=sc.sources.ConstantField(0.3),
        circulating_currents={"hole": "2 uA"}, iterations=2, progress_bar=False,
    )[-1]
    ref.applied_field_func = st.sources.ConstantField(0.3)
    ref.to_hdf5(tmp_path / "solution.h5")
    loaded = st.Solution.from_hdf5(tmp_path / "solution.h5", torch_device="cpu")
    _assert_solutions_bitwise(loaded, ref)
    assert loaded.device == st.device_from_reference(ref_device)
    made = st.Solution(
        device=st.device_from_reference(ref_device),
        film_solutions=loaded.film_solutions,
        applied_field_func=st.sources.ConstantField(0.3),
        field_units=ref.field_units,
        current_units=ref.current_units,
        circulating_currents=ref.circulating_currents,
        vortices=ref.vortices,
        torch_device="cpu",
    )
    assert loaded.equals(made)
    assert loaded.version_info["superscreen_tpu"] == ref.version_info["superscreen_tpu"]


@pytest.mark.parametrize("case", ["stack", "vortex", "terminals"])
def test_port_model_round_trip_is_bitwise(tmp_path, stacks, case):
    """A factorized model saved and reloaded solves to the same bits (the
    LU factors, the systems and the rebuilt Q are the original's)."""
    device = _stack(st, terminals=True) if case == "terminals" else stacks["port"]
    kwargs = dict(current_units="uA", torch_device="cpu")
    if case == "terminals":
        kwargs["terminal_currents"] = {"strip": {"source": 3.0, "drain": -3.0}}
    else:
        kwargs["circulating_currents"] = {"hole": "2 uA"}
    if case == "vortex":
        kwargs["vortices"] = [st.Vortex(x=0.5, y=0.5, film="disk", nPhi0=1)]
    model = st.factorize_model(device=device, **kwargs)
    with h5py.File(tmp_path / "model.h5", "w") as f:
        model.to_hdf5(f)
    with h5py.File(tmp_path / "model.h5", "r") as f:
        loaded = st.FactorizedModel.from_hdf5(f, torch_device="cpu")
    assert loaded.vortices == model.vortices
    solve = dict(applied_field=st.sources.ConstantField(0.3), iterations=2, coupling="exact",
                 torch_device="cpu", progress_bar=False)
    for a, b in zip(st.solve(model=model, **solve), st.solve(model=loaded, **solve)):
        _assert_solutions_bitwise(a, b)


@pytest.mark.parametrize("path", ["dense", "lowmem"])
def test_jax_lu_model_loads_into_port(tmp_path, monkeypatch, path):
    """A float64 JAX model of LU films (the low-memory one padded to 2048
    unknowns) solves in the port to within 1e-12 of the JAX ``solve``."""
    if path == "lowmem":
        monkeypatch.setattr(ref_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    device = _stack(sc)
    model = sc.factorize_model(
        device=device, current_units="uA", circulating_currents={"hole": "2 uA"},
        vortices=[sc.Vortex(x=0.5, y=0.5, film="disk")],
    )
    assert all(info.dense_kernel == (path == "dense") for info in model.film_info.values())
    with h5py.File(tmp_path / "model.h5", "w") as f:
        model.to_hdf5(f)
    with h5py.File(tmp_path / "model.h5", "r") as f:
        loaded = st.FactorizedModel.from_hdf5(f, torch_device="cpu")
    assert all(info.dense_kernel == (path == "dense") for info in loaded.film_info.values())
    ref = sc.solve(model=model, applied_field=sc.sources.ConstantField(0.3), iterations=2,
                   coupling="exact", progress_bar=False)
    out = st.solve(model=loaded, applied_field=st.sources.ConstantField(0.3), iterations=2,
                   coupling="exact", torch_device="cpu", progress_bar=False)
    for a, b in zip(ref, out):
        for name, fs in a.film_solutions.items():
            for key in ("stream", "current_density", "self_field"):
                want = getattr(fs, key)
                got = getattr(b.film_solutions[name], key)
                assert np.abs(got - want).max() <= MODEL_RTOL * np.abs(want).max(), (name, key)


@pytest.mark.parametrize("return_solutions", [True, False])
def test_solve_save_path(tmp_path, stacks, return_solutions):
    """``load_solutions`` returns what ``solve`` returned (or would have)."""
    path = tmp_path / "solutions.h5"
    out = _port_solutions(stacks["port"], save_path=path, return_solutions=return_solutions)
    loaded = st.Solution.load_solutions(path, torch_device="cpu")
    expected = out if return_solutions else _port_solutions(stacks["port"])
    if not return_solutions:
        assert out is None
    assert len(loaded) == len(expected) == 3
    for a, b in zip(loaded, expected):
        assert a.equals(b)
        _assert_solutions_bitwise(a, b)
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["0", "1", "2", "device"]
        assert f["0"]["device"].name == "/0/device"
        assert isinstance(f["0"].get("device", getlink=True), h5py.SoftLink)


def test_save_solutions_links_one_device(tmp_path, stacks):
    solutions = _port_solutions(stacks["port"])
    st.Solution.save_solutions(solutions, tmp_path / "all.h5")
    loaded = st.Solution.load_solutions(tmp_path / "all.h5", torch_device="cpu")
    assert all(a.equals(b) for a, b in zip(loaded, solutions))
    # The JAX package reads the same file.
    ref = sc.Solution.load_solutions(tmp_path / "all.h5")
    assert len(ref) == len(solutions)
    np.testing.assert_array_equal(
        ref[-1].film_solutions["ring"].stream, solutions[-1].film_solutions["ring"].stream
    )


def test_optional_packages_are_imported_when_called():
    """Without h5py, dill, matplotlib and tqdm the package imports and
    solves (with no progress bar); HDF5 and plots raise ImportError naming
    the package."""
    script = """
import sys
for name in ("h5py", "dill", "matplotlib", "tqdm"):
    sys.modules[name] = None
import numpy as np
import superscreen_tpu_torch as st
ring = st.Polygon("ring", layer="base", points=st.geometry.circle(2, points=30))
device = st.Device("d", layers=[st.Layer("base", Lambda=1.0)], films=[ring])
device.make_mesh(max_edge_length=0.8)
solution = st.solve(device, torch_device="cpu", progress_bar=True)[-1]
for call, package in (
    (lambda: device.to_hdf5("device.h5"), "h5py"),
    (lambda: solution.plot_streams(), "matplotlib"),
    (lambda: ring.plot(), "matplotlib"),
    (lambda: st.io._pickled(1), "dill"),
):
    try:
        call()
    except ImportError as err:
        assert repr(package) in str(err), err
    else:
        raise AssertionError(package)
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_vortex_landscape_round_trip(tmp_path):
    """A landscape is saved with its background Solution, as the JAX
    package saves it, and reads back whole."""
    disk = st.Polygon("disk", layer="base", points=geo.circle(3, points=40))
    device = st.Device("disk", layers=[st.Layer("base", Lambda=0.5)], films=[disk],
                       solve_dtype="float64")
    device.make_mesh(max_edge_length=0.7)
    landscape = st.vortex_energy_landscape(
        device, applied_field=st.sources.ConstantField(0.1), current_units="mA",
        torch_device="cpu",
    )
    with h5py.File(tmp_path / "landscape.h5", "w") as f:
        landscape.to_hdf5(f.create_group("landscape"))
    with h5py.File(tmp_path / "landscape.h5", "r") as f:
        assert "background" in f["landscape"]
        loaded = st.VortexLandscape.from_hdf5(f["landscape"], torch_device="cpu")
    for key in ("indices", "sites", "self_energy", "interaction"):
        np.testing.assert_array_equal(getattr(loaded, key), getattr(landscape, key))
    assert (loaded.film, loaded.units) == (landscape.film, landscape.units)
    assert loaded.background.equals(landscape.background)
    np.testing.assert_array_equal(loaded.energy_map(), landscape.energy_map())

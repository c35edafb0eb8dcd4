"""End-to-end parity: the port's ``solve()`` against ``superscreen_tpu.solve``
on the same device and mesh (through ``device_from_reference``), at
float64 on the CPU, plus the port's own contracts."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.solver.utils import make_film_info as ref_make_film_info
from superscreen_tpu_torch.solver.utils import make_film_info
from superscreen_tpu_torch.sweep import relative_residual

torch.set_num_threads(2)

# float64 on both sides; LU pivoting and summation orders differ, which
# costs a few ulp times the systems' condition numbers (~1e3-1e4).
RTOL = 1e-8


def _quickstart():
    layer = sc.Layer("base", london_lambda=0.08, thickness=0.1, z0=0)
    film = sc.Polygon("ring", layer="base", points=sc.geometry.circle(4))
    hole = sc.Polygon("hole", layer="base", points=sc.geometry.circle(2))
    device = sc.Device("ring", layers=[layer], films=[film], holes=[hole], solve_dtype="float64")
    device.make_mesh(max_edge_length=0.9)
    return device, dict(circulating_currents={"hole": "1 mA"})


def _two_rings():
    """bench.py's build_two_layer device at a coarse mesh."""
    layers = [sc.Layer("layer0", Lambda=1.0, z0=0), sc.Layer("layer1", Lambda=0.5, z0=1)]
    films = [
        sc.Polygon("big_ring", layer="layer0", points=sc.geometry.circle(7.5, points=120)),
        sc.Polygon("little_ring", layer="layer1", points=sc.geometry.circle(5, points=100)),
    ]
    holes = [
        sc.Polygon("big_hole", layer="layer0", points=sc.geometry.circle(3.75, points=70)),
        sc.Polygon("little_hole", layer="layer1", points=sc.geometry.circle(2.5, points=60)),
    ]
    device = sc.Device(
        "two_rings", layers=layers, films=films, holes=holes, solve_dtype="float64"
    )
    device.make_mesh(max_edge_length=2.0)
    return device, dict(circulating_currents={"big_hole": "1 mA"}, iterations=3)


_DEVICES = {"quickstart": _quickstart, "two_rings": _two_rings}


@pytest.fixture(scope="module", params=sorted(_DEVICES))
def solved(request):
    ref, kwargs = _DEVICES[request.param]()
    port = st.device_from_reference(ref)
    ref_solutions = sc.solve(
        ref, applied_field=sc.sources.ConstantField(1.0), coupling="exact", **kwargs
    )
    port_solutions = st.solve(
        port, applied_field=st.sources.ConstantField(1.0), torch_device="cpu", **kwargs
    )
    return ref, port, ref_solutions, port_solutions, kwargs


def test_meshes_are_small(solved):
    ref = solved[0]
    assert all(100 < len(m.sites) < 1500 for m in ref.meshes.values())


def test_film_info_index_sets_match(solved):
    ref, port, _, _, kwargs = solved
    circ = {"hole": 1000.0} if "hole" in ref.holes else {"big_hole": 1000.0}
    ref_info = ref_make_film_info(
        device=ref, vortices=[], circulating_currents=circ, terminal_currents={}
    )
    port_info = make_film_info(device=port, circulating_currents=circ, torch_device="cpu")
    for name in ref.films:
        a, b = ref_info[name], port_info[name]
        np.testing.assert_array_equal(b.interior_indices, a.interior_indices)
        np.testing.assert_array_equal(b.boundary_indices, a.boundary_indices)
        np.testing.assert_array_equal(b.in_hole, a.in_hole)
        assert set(b.hole_indices) == set(a.hole_indices)
        for hole in a.hole_indices:
            np.testing.assert_array_equal(b.hole_indices[hole], a.hole_indices[hole])
        assert b.circulating_currents == a.circulating_currents


def test_solution_count_matches(solved):
    _, _, ref_solutions, port_solutions, kwargs = solved
    assert len(port_solutions) == len(ref_solutions) == (
        kwargs.get("iterations", 0) + 1 if len(solved[0].films) > 1 else 1
    )


@pytest.mark.parametrize(
    "field",
    ["stream", "current_density", "applied_field", "self_field", "field_from_other_films"],
)
def test_solutions_match_at_every_iteration(solved, field):
    _, _, ref_solutions, port_solutions, _ = solved
    for i, (r, p) in enumerate(zip(ref_solutions, port_solutions)):
        for name, ref_fs in r.film_solutions.items():
            a = getattr(ref_fs, field)
            b = getattr(p.film_solutions[name], field)
            if a is None:
                assert b is None, (i, name)
                continue
            assert b.shape == a.shape and b.dtype == np.float64
            err = np.abs(b - a).max() / np.abs(a).max()
            assert err <= RTOL, (i, name, field, err)


def test_final_residual_is_small(solved):
    ref, port, _, port_solutions, kwargs = solved
    # Rebuild the model to reach its film tensors (the solve does not
    # return them); the final residual of a float64 solve is ~1e-14.
    model = st.factorize_model(
        device=port, current_units="uA", torch_device="cpu",
        circulating_currents=kwargs["circulating_currents"],
    )
    conv = st.solver.field_conversion_factor("mT", "uA", length_units="um").magnitude
    for name, fs in port_solutions[-1].film_solutions.items():
        data = model.film_data[name]
        Hz = fs.applied_field * conv
        if fs.field_from_other_films is not None:
            Hz = Hz + fs.field_from_other_films * conv
        I_circ = [[model.circulating_currents.get(h, 0.0) for h in data.hole_names]]
        res = relative_residual(
            data,
            torch.as_tensor(Hz[None]),
            torch.as_tensor(I_circ, dtype=torch.float64),
            torch.as_tensor(fs.stream[None]),
        )
        assert float(res[0]) < 1e-10, (name, float(res[0]))


def test_model_reuse_and_circulating_currents():
    ref, _ = _quickstart()
    port = st.device_from_reference(ref)
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    field = st.sources.ConstantField(0.0)
    zero = st.solve(model=model, applied_field=field, torch_device="cpu")[0]
    assert np.abs(zero.film_solutions["ring"].stream).max() == 0.0
    model.set_circulating_currents({"hole": 1000.0})
    one = st.solve(model=model, applied_field=field, torch_device="cpu")[0]
    direct = st.solve(
        port, applied_field=field, circulating_currents={"hole": "1 mA"}, torch_device="cpu"
    )[0]
    np.testing.assert_allclose(
        one.film_solutions["ring"].stream, direct.film_solutions["ring"].stream, rtol=1e-12
    )
    with pytest.raises(KeyError):
        model.set_circulating_currents({"nope": 1.0})


def test_matmul_precision_is_restored():
    ref, kwargs = _quickstart()
    port = st.device_from_reference(ref)
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        st.solve(port, torch_device="cpu", **kwargs)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(previous)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ref, kwargs = _quickstart()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.solve(st.device_from_reference(ref), **kwargs)


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda d: st.solve(d, coupling="fft", torch_device="cpu"), NotImplementedError),
        (lambda d: st.solve(d, coupling="bogus", torch_device="cpu"), ValueError),
        (lambda d: st.solve(d, vortices=[object()], torch_device="cpu"), TypeError),
        (lambda d: st.solve(d, terminal_currents={"ring": {"a": 1.0}}, torch_device="cpu"), KeyError),
        (lambda d: st.solve_many(d, applied_fields=[], final_refine=1, torch_device="cpu"),
         NotImplementedError),
        (lambda d: st.solve_many(d, applied_fields=[], coupling="fft", torch_device="cpu"),
         NotImplementedError),
        (lambda d: st.solve(d, torch_device="meta"), ValueError),
        (lambda d: st.solve(d, circulating_currents={"nope": 1.0}, torch_device="cpu"), KeyError),
        (lambda d: st.solve(d, check_inversion=True, torch_device="cpu"), NotImplementedError),
        (lambda d: st.solve(d, high_precision=True, torch_device="cpu"), NotImplementedError),
        (lambda d: st.solve(d, save_path="out.h5", torch_device="cpu"), NotImplementedError),
        (lambda d: st.solve(d, return_solutions=False, torch_device="cpu"), NotImplementedError),
    ],
)
def test_unsupported_options_raise(call, error):
    ref, _ = _quickstart()
    with pytest.raises(error):
        call(st.device_from_reference(ref))


@pytest.mark.parametrize(
    "kwargs, item",
    [
        (dict(check_inversion=True), "ROADMAP item 2"),
        (dict(high_precision=True), "ROADMAP item 2"),
        (dict(save_path="out.h5"), "ROADMAP item 9"),
        (dict(return_solutions=False), "ROADMAP item 9"),
    ],
)
def test_unported_solve_arguments_name_their_roadmap_item(kwargs, item):
    ref, _ = _quickstart()
    with pytest.raises(NotImplementedError, match=item):
        st.solve(st.device_from_reference(ref), torch_device="cpu", **kwargs)


def test_solve_accepts_every_argument_of_the_reference_at_its_default():
    """The arguments of ``superscreen_tpu.solve`` that the port does not act
    on pass silently at their defaults (and ``progress_bar`` at any value:
    ``Device.mutual_inductance_matrix`` forwards ``progress_bar=False``)."""
    import inspect

    ref_names = set(inspect.signature(sc.solve).parameters) - {"_solver"}
    assert ref_names <= set(inspect.signature(st.solve).parameters)
    ref, kwargs = _quickstart()
    device = st.device_from_reference(ref)
    plain = st.solve(device, torch_device="cpu", **kwargs)
    spelled = st.solve(
        device, torch_device="cpu", check_inversion=False, return_solutions=True,
        save_path=None, log_level=None, progress_bar=False, high_precision=False, **kwargs
    )
    for a, b in zip(plain, spelled):
        for name in device.films:
            np.testing.assert_array_equal(a.film_solutions[name].stream, b.film_solutions[name].stream)


def test_unsupported_device_features_raise():
    # A position-dependent Lambda and terminals are supported; what a layer
    # or a device still refuses is an inconsistent specification.
    assert st.Layer("l", Lambda=st.Constant(0.5)).Lambda(0.0, 0.0) == 0.5
    with pytest.raises(ValueError):
        st.Layer("l", Lambda=st.Constant(0.5), thickness=0.1)
    with pytest.raises(ValueError):
        st.Layer("l", london_lambda=0.1)
    with pytest.raises(AttributeError):
        st.Layer("l", Lambda=1.0).london_lambda = 0.2
    film = st.Polygon("f", layer="l", points=st.geometry.circle(1.0))
    terminal = st.Polygon("t", points=st.geometry.box(0.2, 0.5, center=(1, 0)))
    device = st.Device(
        "d", layers=[st.Layer("l", Lambda=1.0)], films=[film], terminals={"f": [terminal]}
    )
    assert device.terminals["f"][0].layer == "l"
    with pytest.raises(ValueError):
        st.Device("d", layers=[st.Layer("l", Lambda=1.0)], films=[film], terminals={"g": [film]})


def test_import_pulls_in_no_jax_or_reference_package():
    # torch itself imports dill where it is installed, so the check is on
    # what importing the package adds after torch, plus the absence of
    # JAX, the reference package, matplotlib and h5py outright.
    code = (
        "import sys, torch\n"
        "before = set(sys.modules)\n"
        "import superscreen_tpu_torch\n"
        "import superscreen_tpu_torch.sweep, superscreen_tpu_torch.ops.cuda_kernels\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "banned = {'jax', 'jaxlib', 'superscreen_tpu', 'matplotlib', 'h5py', 'dill'}\n"
        "print(sorted(new & banned))\n"
        "print(sorted(m for m in ('jax', 'superscreen_tpu', 'matplotlib', 'h5py') if m in sys.modules))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, check=True, timeout=300, cwd=repo,
    ).stdout.split("\n")
    assert out[0] == "[]" and out[1] == "[]", out


def test_every_module_imports_with_the_other_packages_blocked():
    """Every module of the port imports where JAX, the reference package,
    matplotlib, h5py and dill cannot be imported at all."""
    code = (
        "import sys\n"
        "blocked = ('jax', 'jaxlib', 'superscreen_tpu', 'matplotlib', 'h5py', 'dill')\n"
        "for name in blocked:\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import superscreen_tpu_torch as package\n"
        "names = [package.__name__] + [\n"
        "    m.name for m in pkgutil.walk_packages(package.__path__, package.__name__ + '.')\n"
        "]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert all(sys.modules[name] is None for name in blocked)\n"
        "print(' '.join(names))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    names = out.stdout.split()
    assert len(names) >= 30
    for module in ("fluxoid", "solution", "ops.interp", "sources.current", "sources.dipole",
                   "sources.vortex", "ops.cuda_kernels"):
        assert f"superscreen_tpu_torch.{module}" in names


@pytest.mark.parametrize("k", [0, 1, 3])
def test_lu_solve_matches_dense_solve(k):
    from superscreen_tpu_torch.ops import linalg

    rng = np.random.default_rng(k)
    A = torch.as_tensor(rng.standard_normal((60, 60)) + 8 * np.eye(60))
    h = torch.as_tensor(rng.standard_normal((60, k) if k else 60))
    x = linalg.lu_solve(linalg.factor_system(A), h)
    assert x.shape == h.shape
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(-A, h).numpy(), rtol=1e-12, atol=1e-14)

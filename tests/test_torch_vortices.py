"""Vortices and a position-dependent penetration depth in the port against
the JAX package, on the same meshes (through ``device_from_reference``) at
float64 on the CPU: ``solve()`` and ``solve_many`` with vortices, the
amplitude and position sweeps, ``set_vortices`` and the sweep-data cache,
and an inhomogeneous Lambda on the dense, low-memory LU and BiCGStab
routes."""

import importlib

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.solver import utils as ref_utils
from superscreen_tpu.sweep import solve_many as ref_solve_many
from superscreen_tpu_torch.ops import linalg
from superscreen_tpu_torch.solver import utils as port_utils
from superscreen_tpu_torch.sweep import _get_sweep_data, relative_residual, vortex_flux_quantum

ref_sf = importlib.import_module("superscreen_tpu.solver.solve_film")
port_sf = importlib.import_module("superscreen_tpu_torch.solver.solve_film")

torch.set_num_threads(2)

# float64 on both sides; LU pivoting and summation orders differ, which
# costs a few ulp times the systems' condition numbers (~1e3-1e4).
RTOL = 1e-8
# Both packages stop BiCGStab at a relative residual of 1e-6, after
# different numbers of iterations (the JAX package checks every iteration,
# the port every 25).
BICGSTAB_RTOL = 1e-5
CANDIDATES = [(1.0, 0.0), (-0.8, 0.6)]
QUANTITIES = ["streams", "current_densities", "self_fields"]


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _vortices(module, amps=(1.0, 1.0)):
    return [module.Vortex(x=x, y=y, film="disk", nPhi0=a) for (x, y), a in zip(CANDIDATES, amps)]


@pytest.fixture(scope="module")
def disk():
    """The disk of tests/test_vortex_sweep.py at a coarser mesh."""
    ref = sc.Device(
        "disk",
        layers=[sc.Layer("base", Lambda=0.5, z0=0)],
        films=[sc.Polygon("disk", layer="base", points=sc.geometry.circle(3, points=80))],
        length_units="um",
        solve_dtype="float64",
    )
    ref.make_mesh(min_points=500, smooth=5)
    return ref, st.device_from_reference(ref)


@pytest.fixture(scope="module")
def ring():
    """A ring with a hole: vortices beside circulating currents."""
    ref = sc.Device(
        "ring",
        layers=[sc.Layer("layer1", Lambda=2, z0=0)],
        films=[sc.Polygon("ring", layer="layer1", points=sc.geometry.circle(4, points=80))],
        holes=[sc.Polygon("hole", layer="layer1", points=sc.geometry.circle(2, points=50))],
        solve_dtype="float64",
    )
    ref.make_mesh(max_edge_length=0.7)
    return ref, st.device_from_reference(ref)


def test_meshes_are_small(disk, ring):
    for ref, _ in (disk, ring):
        assert all(100 < len(m.sites) < 1500 for m in ref.meshes.values())


def test_vortex_is_a_plain_record():
    v = st.Vortex(x=1.0, y=2.0, film="f")
    assert (v.x, v.y, v.film, v.nPhi0) == (1.0, 2.0, "f", 1)
    assert v == st.Vortex(1.0, 2.0, "f", 1) and v != st.Vortex(1.0, 2.0, "f", 2)


@pytest.mark.parametrize("field", ["stream", "current_density", "self_field", "applied_field"])
def test_solve_with_a_vortex_matches_jax(ring, field):
    ref, port = ring
    kwargs = dict(circulating_currents={"hole": "0.2 mA"}, field_units="mT", current_units="uA")
    a = sc.solve(
        ref, applied_field=sc.sources.ConstantField(0.3), progress_bar=False,
        vortices=[sc.Vortex(x=3.0, y=0.2, film="ring", nPhi0=2)], **kwargs,
    )[-1]
    b = st.solve(
        port, applied_field=st.sources.ConstantField(0.3), torch_device="cpu",
        vortices=[st.Vortex(x=3.0, y=0.2, film="ring", nPhi0=2)], **kwargs,
    )[-1]
    assert _max_rel(
        getattr(b.film_solutions["ring"], field), getattr(a.film_solutions["ring"], field)
    ) <= RTOL
    assert [(v.x, v.y, v.film, v.nPhi0) for v in b.vortices] == [(3.0, 0.2, "ring", 2)]


def test_vortex_flux_quantum_matches_jax(ring):
    ref, port = ring
    expected = ref.ureg("Phi_0 / mu_0").to("uA * um").magnitude
    assert vortex_flux_quantum(port, "uA") == pytest.approx(expected, rel=1e-12)
    assert vortex_flux_quantum(port, "mA") == pytest.approx(expected / 1e3, rel=1e-12)


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_solve_many_with_fixed_vortices_matches_jax(disk, quantity):
    ref, port = disk
    n = len(ref.meshes["disk"].sites)
    arrays = {"disk": np.full((2, n), 0.2) * np.array([[1.0], [0.0]])}
    a = ref_solve_many(
        device=ref, vortices=_vortices(sc, (2.0, -1.0)), applied_field_arrays=arrays
    )
    b = st.solve_many(
        device=port, vortices=_vortices(st, (2.0, -1.0)), applied_field_arrays=arrays,
        torch_device="cpu",
    )
    assert _max_rel(getattr(b, quantity)["disk"], getattr(a, quantity)["disk"]) <= RTOL
    # Without per-point amplitudes the solutions carry the declared ones.
    assert [v.nPhi0 for v in b.solution(1).vortices] == [2.0, -1.0]


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_vortex_amplitude_sweep_matches_jax(disk, quantity):
    ref, port = disk
    amps = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [2.0, -1.0]])
    n = len(ref.meshes["disk"].sites)
    arrays = {"disk": np.full((len(amps), n), 0.2)}
    a = ref_solve_many(
        device=ref, vortices=_vortices(sc), applied_field_arrays=arrays, vortex_nPhi0=amps
    )
    b = st.solve_many(
        device=port, vortices=_vortices(st), applied_field_arrays=arrays, vortex_nPhi0=amps,
        torch_device="cpu",
    )
    assert _max_rel(getattr(b, quantity)["disk"], getattr(a, quantity)["disk"]) <= RTOL
    for i, row in enumerate(amps):
        np.testing.assert_allclose([v.nPhi0 for v in b.solution(i).vortices], row)
    np.testing.assert_array_equal(b.vortex_nPhi0, a.vortex_nPhi0)


def test_vortex_amplitude_sweep_point_matches_the_port_solve(disk):
    _, port = disk
    amps = np.array([[1.0, 0.0], [2.0, -1.0]])
    n = len(port.meshes["disk"].sites)
    result = st.solve_many(
        device=port, vortices=_vortices(st), applied_field_arrays={"disk": np.full((2, n), 0.2)},
        vortex_nPhi0=amps, torch_device="cpu",
    )
    for i, row in enumerate(amps):
        vortices = [v for v in _vortices(st, row) if v.nPhi0 != 0]
        solution = st.solve(
            port, applied_field=st.sources.ConstantField(0.2), vortices=vortices,
            torch_device="cpu",
        )[-1]
        assert _max_rel(result.streams["disk"][i], solution.film_solutions["disk"].stream) <= 1e-10


def test_vortex_position_sweep_one_hot_and_dict_form(disk):
    ref, port = disk
    n = len(ref.meshes["disk"].sites)
    arrays = {"disk": np.zeros((2, n))}
    a = ref_solve_many(
        device=ref, vortices=_vortices(sc), applied_field_arrays=arrays, vortex_nPhi0=np.eye(2)
    )
    flat = st.solve_many(
        device=port, vortices=_vortices(st), applied_field_arrays=arrays,
        vortex_nPhi0=np.eye(2), torch_device="cpu",
    )
    by_film = st.solve_many(
        device=port, vortices=_vortices(st), applied_field_arrays=arrays,
        vortex_nPhi0={"disk": np.eye(2)}, torch_device="cpu",
    )
    assert _max_rel(flat.streams["disk"], a.streams["disk"]) <= RTOL
    np.testing.assert_array_equal(by_film.streams["disk"], flat.streams["disk"])
    for i, (x, y) in enumerate(CANDIDATES):
        one = st.solve(
            port, vortices=[st.Vortex(x=x, y=y, film="disk")], torch_device="cpu"
        )[-1]
        assert _max_rel(flat.streams["disk"][i], one.film_solutions["disk"].stream) <= 1e-10


@pytest.mark.parametrize(
    "vortex_nPhi0", [np.ones((2, 3)), np.ones((3, 2)), {"nope": np.eye(2)}, {"disk": np.ones((2, 1))}]
)
def test_vortex_amplitude_validation(disk, vortex_nPhi0):
    ref, port = disk
    n = len(port.meshes["disk"].sites)
    arrays = {"disk": np.zeros((2, n))}
    with pytest.raises(ValueError):
        st.solve_many(
            device=port, vortices=_vortices(st), applied_field_arrays=arrays,
            vortex_nPhi0=vortex_nPhi0, torch_device="cpu",
        )
    with pytest.raises(ValueError):
        ref_solve_many(
            device=ref, vortices=_vortices(sc), applied_field_arrays=arrays,
            vortex_nPhi0=vortex_nPhi0,
        )


@pytest.mark.parametrize(
    "vortex, error",
    [
        (dict(x=0.0, y=0.0, film="ring"), ValueError),  # in the hole
        (dict(x=9.0, y=0.0, film="ring"), ValueError),  # outside its film
        ("not a vortex", TypeError),
    ],
)
def test_misplaced_vortices_raise(ring, vortex, error):
    ref, port = ring
    make = lambda module: module.Vortex(**vortex) if isinstance(vortex, dict) else vortex
    with pytest.raises(error):
        st.factorize_model(
            device=port, current_units="uA", vortices=[make(st)], torch_device="cpu"
        )
    with pytest.raises(error):
        sc.factorize_model(device=ref, current_units="uA", vortices=[make(sc)])
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    with pytest.raises(error):
        model.set_vortices([make(st)])


def test_set_vortices_rebuilds_only_the_vortex_columns(ring):
    ref, port = ring
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    data = _get_sweep_data(model)["ring"]
    assert data is model.film_data["ring"] and data.vortex_cols is None
    assert _get_sweep_data(model) is model.film_data  # the cache holds
    vortex = st.Vortex(x=3.0, y=0.2, film="ring")
    model.set_vortices([vortex])
    assert model.vortices == {"ring": (vortex,)} and model.film_data["ring"] is data
    field = st.sources.ConstantField(0.3)
    solution = st.solve(model=model, applied_field=field, torch_device="cpu")[-1]
    rebuilt = model.film_data["ring"]
    assert rebuilt is not data and rebuilt.vortex_cols.shape == (len(rebuilt.interior), 1)
    assert rebuilt.Qw is data.Qw and rebuilt.factors is data.factors  # nothing else was rebuilt
    assert _get_sweep_data(model)["ring"] is rebuilt
    direct = st.solve(port, applied_field=field, vortices=[vortex], torch_device="cpu")[-1]
    np.testing.assert_allclose(
        solution.film_solutions["ring"].stream, direct.film_solutions["ring"].stream, rtol=1e-12
    )
    ref_model = sc.factorize_model(device=ref, current_units="uA")
    ref_model.set_vortices([sc.Vortex(x=3.0, y=0.2, film="ring")])
    expected = sc.solve(
        model=ref_model, applied_field=sc.sources.ConstantField(0.3), progress_bar=False
    )[-1]
    assert _max_rel(
        solution.film_solutions["ring"].stream, expected.film_solutions["ring"].stream
    ) <= RTOL
    # The residual takes the vortex term out of the stream.
    conv = st.solver.field_conversion_factor("mT", "uA", length_units="um").magnitude
    fs = solution.film_solutions["ring"]
    args = (
        rebuilt, torch.as_tensor(fs.applied_field[None] * conv),
        torch.zeros((1, 1), dtype=torch.float64), torch.as_tensor(fs.stream[None]),
    )
    assert float(relative_residual(*args, vortex_flux_quantum(port, "uA"))[0]) < 1e-10
    assert float(relative_residual(*args)[0]) > 1e-3


def test_model_copy_has_independent_drive_state(ring):
    _, port = ring
    model = st.factorize_model(
        device=port, current_units="uA", circulating_currents={"hole": 5.0}, torch_device="cpu"
    )
    clone = model.copy()
    clone.set_vortices([st.Vortex(x=3.0, y=0.2, film="ring")])
    clone.set_circulating_currents({"hole": 7.0})
    field = st.sources.ConstantField(0.3)
    st.solve(model=clone, applied_field=field, torch_device="cpu")
    assert model.vortices == {"ring": ()} and model.circulating_currents == {"hole": 5.0}
    assert model.film_info["ring"].vortices == ()
    assert model.film_data["ring"].vortex_cols is None
    assert clone.film_data["ring"].vortex_cols is not None
    assert clone.film_systems is model.film_systems  # the factorizations are shared


def _weak_spot(x, y, x0=1.0, y0=2.5, sigma=1.2, depth=0.8, base=2.0):
    """A penetration depth with a Gaussian weak spot."""
    return base * (1 + depth * np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2)))


def _with_weak_spot(ref):
    dev = ref.copy(with_mesh=True)
    dev.solve_dtype = ref.solve_dtype
    dev.layers["layer1"].Lambda = sc.Parameter(_weak_spot, sigma=1.0) * 1.5 + 0.25
    return dev, st.device_from_reference(dev)


def _ring_solve(module, device, **kwargs):
    return module.solve(
        device, applied_field=module.sources.ConstantField(0.5),
        circulating_currents={"hole": "500 uA"}, **kwargs,
    )[-1]


def test_parameter_lambda_is_carried_over(ring):
    ref, port = _with_weak_spot(ring[0])
    a, b = ref.layers["layer1"], port.layers["layer1"]
    assert isinstance(b.Lambda, st.Parameter) and b.london_lambda is None
    sites = ref.meshes["ring"].sites
    np.testing.assert_array_equal(b.Lambda(sites[:, 0], sites[:, 1]), a.Lambda(sites[:, 0], sites[:, 1]))
    assert isinstance(b.copy().Lambda, st.Parameter) and "Parameter" in repr(b)
    london = sc.Layer("l", london_lambda=sc.Parameter(_weak_spot), thickness=0.5)
    assert london.Lambda(0.3, 0.4) == pytest.approx(
        st.Layer("l", london_lambda=st.Parameter(_weak_spot), thickness=0.5).Lambda(0.3, 0.4)
    )
    ref_info = ref_utils.make_film_info(
        device=ref, vortices=[], circulating_currents={}, terminal_currents={}
    )["ring"]
    info = port_utils.make_film_info(device=port, circulating_currents={}, torch_device="cpu")["ring"]
    assert info.lambda_info.inhomogeneous and ref_info.lambda_info.inhomogeneous
    np.testing.assert_array_equal(info.lambda_info.Lambda, ref_info.lambda_info.Lambda)
    assert info.gradient.shape == (2, len(sites), len(sites)) and info.gradient_coo is None
    assert _max_rel(info.gradient.numpy(), np.asarray(ref_info.gradient)) <= 1e-14
    flat = port_utils.make_film_info(
        device=ring[1], circulating_currents={}, torch_device="cpu"
    )["ring"]
    assert not flat.lambda_info.inhomogeneous and flat.gradient is None
    with pytest.raises(ValueError, match="Negative Lambda"):
        port_utils.LambdaInfo(film="f", Lambda=np.array([[1.0], [-1.0]]))


@pytest.mark.parametrize("field", ["stream", "current_density", "self_field"])
def test_inhomogeneous_lambda_dense_matches_jax(ring, field):
    ref, port = _with_weak_spot(ring[0])
    a = _ring_solve(sc, ref, progress_bar=False)
    b = _ring_solve(st, port, torch_device="cpu")
    assert _max_rel(
        getattr(b.film_solutions["ring"], field), getattr(a.film_solutions["ring"], field)
    ) <= RTOL
    flat = _ring_solve(st, ring[1], torch_device="cpu")
    assert _max_rel(flat.film_solutions["ring"].stream, b.film_solutions["ring"].stream) > 1e-2


def _lowmem(mp):
    mp.setattr(ref_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    mp.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)


@pytest.mark.parametrize("field", ["stream", "current_density", "self_field"])
def test_inhomogeneous_lambda_low_memory_lu_matches_jax(ring, field, monkeypatch):
    ref, port = _with_weak_spot(ring[0])
    dense = _ring_solve(st, port, torch_device="cpu")
    _lowmem(monkeypatch)
    a = _ring_solve(sc, ref, progress_bar=False)
    b = _ring_solve(st, port, torch_device="cpu")
    for other in (a, dense):
        assert _max_rel(
            getattr(b.film_solutions["ring"], field), getattr(other.film_solutions["ring"], field)
        ) <= RTOL


def test_inhomogeneous_low_memory_assembly_matches_jax(ring, monkeypatch):
    ref, port = _with_weak_spot(ring[0])
    _lowmem(monkeypatch)
    ref_info = ref_utils.make_film_info(
        device=ref, vortices=[], circulating_currents={}, terminal_currents={}
    )["ring"]
    info = port_utils.make_film_info(device=port, circulating_currents={}, torch_device="cpu")["ring"]
    assert info.gradient is None and len(info.gradient_coo) == 2
    ix = np.setdiff1d(info.interior_indices, info.hole_indices["hole"])
    triplets = port_sf._lowmem_grad_lambda_triplets(info, ix)
    for got, expected in zip(triplets, ref_sf._lowmem_grad_lambda_triplets(ref_info, ix)):
        np.testing.assert_allclose(got, expected, rtol=1e-13, atol=0)
    sites = torch.as_tensor(info.sites)
    A_ref = np.asarray(ref_sf._build_system_2d_lowmem(ref_info, ix, pad_to=None, pad_n=None))
    A = port_sf._build_system_2d_lowmem(info, ix, sites)
    assert _max_rel(A.numpy(), A_ref) <= 1e-12
    assert float((A - A.T * (info.weights[ix] / info.weights[ix][:, None])).abs().max()) > 1e-6
    hole = info.hole_indices["hole"]
    v_ref = np.asarray(ref_sf._hole_effective_field_vector_lowmem(ref_info, hole))
    v = port_sf._hole_effective_field_vector_lowmem(info, hole, sites)
    assert _max_rel(v.numpy(), v_ref) <= 1e-12
    op = port_sf._lowmem_operator_pieces(info, ix, sites)
    assert op["nonsym"] is True
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((len(ix), 2)))
    assert _max_rel(linalg.brandt_matvec(op, x).numpy(), (A @ x).numpy()) <= 1e-12


@pytest.fixture(scope="module")
def bicgstab(ring):
    ref, port = _with_weak_spot(ring[0])
    dense = _ring_solve(st, port, torch_device="cpu")
    arrays = {"ring": np.full((2, len(ref.meshes["ring"].sites)), 0.5) * np.array([[1.0], [0.4]])}
    circ = [{"hole": 500.0}, {"hole": -100.0}]
    vortices = lambda module: [module.Vortex(x=3.0, y=0.2, film="ring")]
    with pytest.MonkeyPatch.context() as mp:
        _lowmem(mp)
        mp.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "cg")
        linalg.CG_STATS.update(solves=0, iterations=0, max_residual=0.0)
        model = st.factorize_model(
            device=port, current_units="uA", circulating_currents={"hole": "500 uA"},
            torch_device="cpu",
        )
        solution = st.solve(
            model=model, applied_field=st.sources.ConstantField(0.5), torch_device="cpu"
        )[-1]
        stats = dict(linalg.CG_STATS)
        ref_sweep = ref_solve_many(
            ref, applied_field_arrays=arrays, circulating_currents=circ, vortices=vortices(sc)
        )
        sweep = st.solve_many(
            port, applied_field_arrays=arrays, circulating_currents=circ, vortices=vortices(st),
            torch_device="cpu",
        )
    return dict(model=model, dense=dense, solution=solution, stats=stats,
                ref_sweep=ref_sweep, sweep=sweep)


def test_inhomogeneous_matrix_free_film_takes_bicgstab(bicgstab):
    model = bicgstab["model"]
    system, data = model.film_systems["ring"], model.film_data["ring"]
    assert system.A is None and system.lu_piv is None and system.cg_op["nonsym"] is True
    assert data.fac_kind == "bicgstab" and data.A is None and data.Qw is None
    assert bicgstab["stats"]["solves"] == 1 and bicgstab["stats"]["max_residual"] < 1e-6
    # Against the port's own dense LU answer.
    for field in ("stream", "self_field"):
        assert _max_rel(
            getattr(bicgstab["solution"].film_solutions["ring"], field),
            getattr(bicgstab["dense"].film_solutions["ring"], field),
        ) <= BICGSTAB_RTOL


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_bicgstab_sweep_with_a_vortex_matches_jax(bicgstab, quantity):
    """B = 2 with circulating currents and a vortex whose response column
    is built through the matrix-free solve, on both sides."""
    a = getattr(bicgstab["ref_sweep"], quantity)["ring"]
    b = getattr(bicgstab["sweep"], quantity)["ring"]
    assert _max_rel(b, a) <= BICGSTAB_RTOL, _max_rel(b, a)


@pytest.mark.parametrize("nonsym", [False, True])
def test_matrix_free_solve_routes_on_the_operator(bicgstab, nonsym, monkeypatch):
    op = dict(bicgstab["model"].film_systems["ring"].cg_op, nonsym=nonsym)
    called = []
    monkeypatch.setattr(linalg, "brandt_cg_solve_host", lambda op, h: called.append("cg"))
    monkeypatch.setattr(linalg, "brandt_bicgstab_solve_host", lambda op, h: called.append("bicgstab"))
    # A float64 solve is one Krylov solve (a float32 one is followed by a
    # correction solve on the float64 residual).
    linalg.matrix_free_solve_host(op, torch.zeros(3, dtype=torch.float64))
    assert called == ["bicgstab" if nonsym else "cg"]


def test_bicgstab_solves_the_nonsymmetric_system(bicgstab, caplog):
    model = bicgstab["model"]
    op = model.film_systems["ring"].cg_op
    ni = len(model.film_systems["ring"].indices)
    h = torch.as_tensor(np.random.default_rng(8).standard_normal((ni, 3)))
    x = linalg.brandt_bicgstab_solve_host(op, h)
    r = h + linalg.brandt_matvec(op, x)
    assert float((r.norm(dim=0) / h.norm(dim=0)).max()) < 1e-5
    one = linalg.brandt_bicgstab_solve_host(op, h[:, 0])
    assert one.shape == (ni,) and _max_rel(one.numpy(), x[:, 0].numpy()) <= 1e-5
    with caplog.at_level("WARNING", logger="solve"):
        linalg.brandt_bicgstab_solve_host(op, h, maxiter=2, chunk=2)
    assert "BiCGStab solve did NOT converge" in caplog.text


@pytest.mark.parametrize("steps", [0, 2])
def test_lu_solve_refined(steps):
    rng = np.random.default_rng(steps)
    A = torch.as_tensor(rng.standard_normal((50, 50)) + 8 * np.eye(50))
    h = torch.as_tensor(rng.standard_normal((50, 2)))
    x = linalg.lu_solve_refined(A, linalg.factor_system(A), h, refine_steps=steps)
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(-A, h).numpy(), rtol=1e-11, atol=1e-13)

"""The port's low-memory path against the JAX package's.

Films above ``MAX_DENSE_KERNEL_SIZE`` sites never build the full Brandt
kernel.  The threshold is lowered to 10 sites on both packages (as
``tests/test_lowmem.py`` does), so the small parity devices of
``tests/test_torch_solve.py`` take that path, and the same mesh runs
through both at float64 on the CPU.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.solver import utils as ref_utils
from superscreen_tpu_torch.ops import kernels, linalg
from superscreen_tpu_torch.ops.fem import COO
from superscreen_tpu_torch.solver import utils as port_utils
from superscreen_tpu_torch.sweep import relative_residual
from test_torch_solve import _DEVICES

ref_sf = importlib.import_module("superscreen_tpu.solver.solve_film")
port_sf = importlib.import_module("superscreen_tpu_torch.solver.solve_film")

torch.set_num_threads(2)

# float64 on both sides; LU pivoting and summation orders differ, which
# costs a few ulp times the systems' condition numbers (~1e3-1e4).
RTOL = 1e-8
# The CG solves stop at a relative residual of 1e-6 (tests/test_lowmem.py
# holds the JAX package's CG answer to 1e-5 of the dense one).
CG_RTOL = 1e-5
FIELDS = ["stream", "current_density", "applied_field", "self_field", "field_from_other_films"]


def _lowmem(mp):
    mp.setattr(ref_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    mp.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)


def _port_solve(port, kwargs, **extra):
    model = st.factorize_model(
        device=port,
        current_units="uA",
        circulating_currents=kwargs["circulating_currents"],
        torch_device="cpu",
    )
    solutions = st.solve(
        model=model,
        applied_field=st.sources.ConstantField(1.0),
        iterations=kwargs.get("iterations", 0),
        torch_device="cpu",
        **extra,
    )
    return model, solutions


def _max_rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module", params=sorted(_DEVICES))
def solved(request):
    ref, kwargs = _DEVICES[request.param]()
    port = st.device_from_reference(ref)
    dense = st.solve(
        port, applied_field=st.sources.ConstantField(1.0), torch_device="cpu", **kwargs
    )
    with pytest.MonkeyPatch.context() as mp:
        _lowmem(mp)
        ref_solutions = sc.solve(
            ref, applied_field=sc.sources.ConstantField(1.0), coupling="exact", **kwargs
        )
        model, port_solutions = _port_solve(port, kwargs)
    return dict(
        ref=ref, port=port, kwargs=kwargs, dense=dense, ref_solutions=ref_solutions,
        model=model, solutions=port_solutions,
    )


def test_films_take_the_low_memory_path(solved):
    model = solved["model"]
    for name, info in model.film_info.items():
        assert not info.dense_kernel and info.kernel is None
        assert isinstance(info.laplacian, COO)
        data = model.film_data[name]
        assert data.Qw is None and data.fac_kind == "lu" and data.cg_op is None
        assert data.A.shape == (len(data.interior),) * 2
        for system in model.hole_systems[name].values():
            assert system.A.shape == (len(info.weights),)


@pytest.mark.parametrize("field", FIELDS)
def test_solutions_match_jax_lowmem_at_every_iteration(solved, field):
    ref_solutions, solutions = solved["ref_solutions"], solved["solutions"]
    assert len(solutions) == len(ref_solutions)
    for i, (r, p) in enumerate(zip(ref_solutions, solutions)):
        for name, ref_fs in r.film_solutions.items():
            a = getattr(ref_fs, field)
            b = getattr(p.film_solutions[name], field)
            if a is None:
                assert b is None, (i, name)
                continue
            assert b.shape == a.shape and b.dtype == np.float64
            assert _max_rel(b, a) <= RTOL, (i, name, field, _max_rel(b, a))


def test_lowmem_matches_the_port_dense_path(solved):
    for low, dense in zip(solved["solutions"], solved["dense"]):
        for name, fs in dense.film_solutions.items():
            for field in ("stream", "self_field"):
                a = getattr(fs, field)
                assert _max_rel(getattr(low.film_solutions[name], field), a) <= RTOL


def test_assembly_and_hole_vectors_match_jax(solved, monkeypatch):
    ref, port = solved["ref"], solved["port"]
    _lowmem(monkeypatch)
    circ = {hole: 1.0 for hole in ref.holes}
    ref_info = ref_utils.make_film_info(
        device=ref, vortices=[], circulating_currents=circ, terminal_currents={}
    )
    port_info = port_utils.make_film_info(
        device=port, circulating_currents=circ, torch_device="cpu"
    )
    for name, info in port_info.items():
        ix = np.setdiff1d(
            info.interior_indices, np.concatenate(list(info.hole_indices.values()))
        )
        sites = torch.as_tensor(info.sites)
        A_ref = np.asarray(
            ref_sf._build_system_2d_lowmem(ref_info[name], ix, pad_to=None, pad_n=None)
        )
        A = port_sf._build_system_2d_lowmem(info, ix, sites).numpy()
        assert A.shape == A_ref.shape == (len(ix), len(ix))
        assert np.abs(A - A_ref).max() <= 1e-12 * np.abs(A_ref).max()
        for hole, hole_ix in info.hole_indices.items():
            v_ref = np.asarray(ref_sf._hole_effective_field_vector_lowmem(ref_info[name], hole_ix))
            v = port_sf._hole_effective_field_vector_lowmem(info, hole_ix, sites).numpy()
            assert np.abs(v - v_ref).max() <= 1e-12 * np.abs(v_ref).max(), (name, hole)


def test_final_residual_is_small(solved):
    model = solved["model"]
    conv = st.solver.field_conversion_factor("mT", "uA", length_units="um").magnitude
    for name, fs in solved["solutions"][-1].film_solutions.items():
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


def test_pair_coupling_matches_two_passes(monkeypatch):
    ref, kwargs = _DEVICES["two_rings"]()
    port = st.device_from_reference(ref)
    _lowmem(monkeypatch)
    _, two_pass = _port_solve(port, kwargs)
    monkeypatch.setenv("SUPERSCREEN_TPU_PAIR_COUPLING", "1")
    _, paired = _port_solve(port, kwargs)
    for p, two in zip(paired, two_pass):
        for name, fs in two.film_solutions.items():
            for field in ("stream", "self_field", "field_from_other_films"):
                a = getattr(fs, field)
                if a is None:
                    continue
                assert _max_rel(getattr(p.film_solutions[name], field), a) <= 1e-12


def test_lowmem_path_builds_no_full_kernel(monkeypatch):
    """No (n, n) tensor: the dense kernel is never assembled, and the only
    q_matrix call is the interior q-block of each film."""
    ref, kwargs = _DEVICES["two_rings"]()
    port = st.device_from_reference(ref)
    _lowmem(monkeypatch)
    shapes = []
    q_matrix = kernels.q_matrix

    def spy(points):
        shapes.append(tuple(points.shape))
        return q_matrix(points)

    def refuse(*args, **kw):
        raise AssertionError("the dense Q was assembled")

    monkeypatch.setattr(kernels, "q_matrix", spy)
    monkeypatch.setattr(st.MeshOperators, "Q_dense", refuse)
    model, solutions = _port_solve(port, kwargs)
    sizes = sorted(len(model.film_systems[name].indices) for name in port.films)
    assert sorted(s[0] for s in shapes) == sizes
    assert all(s < len(m.sites) for s, m in zip(sizes, port.meshes.values()))
    assert all(np.isfinite(fs.stream).all() for fs in solutions[-1].film_solutions.values())


@pytest.fixture(scope="module")
def cg_solved():
    ref, kwargs = _DEVICES["quickstart"]()
    port = st.device_from_reference(ref)
    dense = st.solve(port, applied_field=st.sources.ConstantField(1.0), torch_device="cpu", **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        _lowmem(mp)
        mp.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "cg")
        ref_cg = sc.solve(ref, applied_field=sc.sources.ConstantField(1.0), **kwargs)
        model, cg = _port_solve(port, kwargs)
    return dict(model=model, dense=dense, ref_cg=ref_cg, cg=cg)


def test_cg_route_builds_no_system(cg_solved):
    model = cg_solved["model"]
    system = model.film_systems["ring"]
    assert system.A is None and system.lu_piv is None and system.cg_op is not None
    data = model.film_data["ring"]
    assert data.fac_kind == "cg" and data.A is None and data.Qw is None


@pytest.mark.parametrize("field", ["stream", "current_density", "self_field"])
def test_cg_matches_dense_and_jax_cg(cg_solved, field):
    b = getattr(cg_solved["cg"][-1].film_solutions["ring"], field)
    for other in (cg_solved["dense"], cg_solved["ref_cg"]):
        a = getattr(other[-1].film_solutions["ring"], field)
        assert _max_rel(b, a) <= CG_RTOL, (field, _max_rel(b, a))


def test_cg_residual_through_the_matrix_free_operator(cg_solved):
    model = cg_solved["model"]
    data = model.film_data["ring"]
    fs = cg_solved["cg"][-1].film_solutions["ring"]
    conv = st.solver.field_conversion_factor("mT", "uA", length_units="um").magnitude
    res = relative_residual(
        data,
        torch.as_tensor(fs.applied_field[None] * conv),
        torch.as_tensor([[model.circulating_currents["hole"]]], dtype=torch.float64),
        torch.as_tensor(fs.stream[None]),
    )
    assert float(res[0]) < 1e-6


def test_brandt_matvec_matches_the_materialized_system(cg_solved, monkeypatch):
    data = cg_solved["model"].film_data["ring"]
    info = cg_solved["model"].film_info["ring"]
    A = port_sf._build_system_2d_lowmem(
        info, data.interior.numpy(), torch.as_tensor(info.sites)
    )
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((len(data.interior), 3)))
    np.testing.assert_allclose(
        linalg.brandt_matvec(data.cg_op, x).numpy(), (A @ x).numpy(), rtol=1e-10,
        atol=1e-12 * float((A @ x).abs().max()),
    )


def test_unconverged_cg_warns(cg_solved, caplog):
    data = cg_solved["model"].film_data["ring"]
    h = torch.ones(len(data.interior), dtype=torch.float64)
    with caplog.at_level(logging.WARNING, logger="solve"):
        x = linalg.brandt_cg_solve_host(data.cg_op, h, maxiter=3, chunk=2)
    assert x.shape == h.shape and torch.isfinite(x).all()
    assert "did NOT converge" in caplog.text


@pytest.mark.parametrize("margin, kind", [(-1, "cg"), (0, "lu")])
def test_materialized_ceiling_routes_large_interiors_to_cg(monkeypatch, margin, kind):
    ref, _ = _DEVICES["quickstart"]()
    port = st.device_from_reference(ref)
    _lowmem(monkeypatch)
    info = port_utils.make_film_info(device=port, circulating_currents={}, torch_device="cpu")
    ni = len(np.setdiff1d(info["ring"].interior_indices, info["ring"].hole_indices["hole"]))
    monkeypatch.setenv("SUPERSCREEN_TPU_MAX_MATERIALIZED_N", str(ni + margin))
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    assert model.film_data["ring"].fac_kind == kind
    assert (model.film_systems["ring"].A is None) == (kind == "cg")


def test_default_materialized_ceiling_follows_the_dtype(monkeypatch):
    # Three (ni, ni) buffers in MAX_MATERIALIZED_BYTES.
    monkeypatch.delenv("SUPERSCREEN_TPU_MAX_MATERIALIZED_N", raising=False)
    assert port_sf.max_materialized_n(torch.float32) == 75000
    assert port_sf.max_materialized_n(torch.float64) == 53033
    monkeypatch.setenv("SUPERSCREEN_TPU_MAX_MATERIALIZED_N", "123")
    assert port_sf.max_materialized_n(torch.float64) == 123


def test_unknown_large_factor_method_raises(monkeypatch):
    ref, _ = _DEVICES["quickstart"]()
    monkeypatch.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "bogus")
    with pytest.raises(ValueError, match="SUPERSCREEN_TPU_LARGE_FACTOR"):
        st.factorize_model(
            device=st.device_from_reference(ref), current_units="uA", torch_device="cpu"
        )

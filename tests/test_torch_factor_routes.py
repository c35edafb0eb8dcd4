"""The large-film factorization routes of ``ops.linalg.factor_system``
(``SUPERSCREEN_TPU_LARGE_FACTOR``: ``"inv"``, ``"chol"``, ``"schur"``,
``"schulz"``, and ``"cg"`` on a materialized system) against the JAX
package's route functions, and every consumer of their factors, on the
CPU at float64.

On the CPU both packages take LU for every film, as the JAX package's
``_on_cpu()`` does.  The tests reach the routes by lowering
``LU_MAX_N_TPU`` and opening the device gate (``ops.linalg._on_cpu``), as
a system on the card above the threshold would take them."""

import dataclasses
import importlib
import io
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax.numpy as jnp
import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu import certify as ref_certify
from superscreen_tpu import vortices as ref_vortices
from superscreen_tpu.ops import linalg as jlinalg
from superscreen_tpu.sweep import _film_sweep_data, _run_sweep
from superscreen_tpu_torch import certify, vortices
from superscreen_tpu_torch.ops import linalg, rows

solve_film = importlib.import_module("superscreen_tpu_torch.solver.solve_film")
ref_solve_film = importlib.import_module("superscreen_tpu.solver.solve_film")

torch.set_num_threads(2)

ROUTES = ["inv", "chol", "schur", "schulz", "cg"]
# The JAX tests' bars: factors and solves of the same A to 1e-10 (the
# Schulz iteration, which converges to its own floor, to 1e-8); whole
# solves through each route against the JAX package's LU solve to 1e-8.
FACTOR_TOL = 1e-10
SCHULZ_TOL = 1e-8
SOLVE_TOL = 1e-8
# The residual bar of every film's final round (PERF.md section 2).
RESIDUAL_BAR = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _two_rings(dtype="float64", Lambda=1):
    layers = [sc.Layer("layer0", Lambda=Lambda, z0=0), sc.Layer("layer1", Lambda=1, z0=1)]
    films = [
        sc.Polygon("big_ring", layer="layer0", points=geo.circle(7.5, points=80)),
        sc.Polygon("little_ring", layer="layer1", points=geo.circle(5, points=60)),
    ]
    holes = [
        sc.Polygon("big_hole", layer="layer0", points=geo.circle(3.75, points=40)),
        sc.Polygon("little_hole", layer="layer1", points=geo.circle(2.5, points=30)),
    ]
    device = sc.Device("two_rings", layers=layers, films=films, holes=holes, solve_dtype=dtype)
    device.make_mesh(max_edge_length=0.9)
    return device


@pytest.fixture
def on_the_card(monkeypatch):
    """Every film system takes the large-film route: the device gate open
    and the threshold below any film."""
    monkeypatch.setattr(linalg, "_on_cpu", lambda A: False)
    monkeypatch.setattr(linalg, "LU_MAX_N_TPU", 0)
    monkeypatch.delenv("SUPERSCREEN_TPU_LARGE_FACTOR", raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def ref():
    device = _two_rings()
    model = sc.factorize_model(device=device, current_units="uA")
    return dict(device=device, model=model, port=st.device_from_reference(device))


@pytest.fixture(scope="module")
def system(ref):
    """The big ring's interior system ``A`` and weights ``w`` of the JAX
    package's float64 model, a right-hand side block, and the JAX route
    factors of that ``A``."""
    fs = ref["model"].film_systems["big_ring"]
    A = np.asarray(fs.A)
    w = np.asarray(ref["model"].film_info["big_ring"].weights)[fs.indices]
    h = np.random.default_rng(0).standard_normal((A.shape[0], 3))
    jA, jw = jnp.asarray(A), jnp.asarray(w)
    jax_factors = {
        "inv": ("inv", jlinalg._jax_chol_explicit_inverse_from_A(jA, jw), jw),
        "chol": ("chol", jlinalg._jax_chol_factor(-jA, jw), jw),
        "schur": ("inv", jlinalg._jax_schur_explicit_inverse_from_A(jA, jw), jw),
        "schulz": ("inv", jlinalg._jax_spd_inverse(-jA, jw), jw),
    }
    jax_factors["cg"] = jax_factors["schur"]
    return dict(A=A, w=w, h=h, jax=jax_factors)


def _port_factors(system, route, monkeypatch):
    monkeypatch.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    return linalg.factor_system(torch.as_tensor(system["A"]), torch.as_tensor(system["w"]))


def test_a_small_system_needs_lu_max_n_lowered(system):
    assert system["A"].shape[0] > 200 and linalg.LU_MAX_N_TPU == 12288


@pytest.mark.parametrize("route", ROUTES)
def test_route_factors_match_the_jax_route_functions(system, on_the_card, route):
    """Each route's factor of the same ``A`` and ``w`` against the JAX
    package's function (``"cg"`` on a materialized system is Schur)."""
    factors = _port_factors(system, route, on_the_card)
    jax_factors = system["jax"][route]
    assert factors[0] == jax_factors[0] and linalg.factor_kind(factors) == factors[0]
    assert isinstance(factors[1], torch.Tensor) and factors[1].dtype == torch.float64
    tol = SCHULZ_TOL if route == "schulz" else FACTOR_TOL
    assert _rel(factors[1], jax_factors[1]) <= tol
    assert torch.equal(factors[2], torch.as_tensor(system["w"]))


@pytest.mark.parametrize("block", [7, 64, 2048])
def test_blocked_inverse_and_cholesky_at_any_block(system, block):
    """The in-place blocked Cholesky, triangular inverse and product agree
    with the JAX functions whatever the block, a ragged last one
    included."""
    A, w = torch.as_tensor(system["A"]), torch.as_tensor(system["w"])
    M = linalg._chol_explicit_inverse(A, w, block)
    assert _rel(M, system["jax"]["inv"][1]) <= FACTOR_TOL
    L = linalg._cholesky_(linalg._spd_part(A, w), block)
    assert _rel(L, system["jax"]["chol"][1]) <= FACTOR_TOL
    assert bool((L.triu(1) == 0).all())


def test_cholesky_of_a_matrix_that_is_not_positive_definite_raises(on_the_card):
    """A failed Cholesky raises; nothing retries LU."""
    A = torch.diag(torch.tensor([1.0, -1.0, 2.0], dtype=torch.float64))
    for route in ("inv", "chol"):
        on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
        with pytest.raises(torch.linalg.LinAlgError):
            linalg.factor_system(A, torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("refined", [False, True], ids=["lu_solve", "lu_solve_refined"])
def test_solves_with_each_tag_match_jax(system, on_the_card, route, refined):
    factors = _port_factors(system, route, on_the_card)
    A, h = system["A"], system["h"]
    jax_factors = system["jax"][route]
    for rhs in (h, h[:, 0]):
        if refined:
            x = linalg.lu_solve_refined(torch.as_tensor(A), factors, torch.as_tensor(rhs))
            ref_x = jlinalg.lu_solve_refined(A, jax_factors, rhs)
        else:
            x = linalg.lu_solve(factors, torch.as_tensor(rhs))
            ref_x = jlinalg.lu_solve(jax_factors, rhs)
        assert x.shape == rhs.shape
        assert _rel(x, ref_x) <= FACTOR_TOL
        assert _rel(x, np.linalg.solve(-A, rhs)) <= FACTOR_TOL


def test_mixed_preconditioner_refines_to_float64_on_every_tag(system, on_the_card):
    """A float64 system with float32 factors of each form (the float32 twin
    of ``solve(high_precision=True)``) is solved to the float64 floor."""
    A64 = torch.as_tensor(system["A"])
    w = torch.as_tensor(system["w"])
    h = torch.as_tensor(system["h"])
    ref_x = np.linalg.solve(-system["A"], system["h"])
    for route in ("inv", "chol"):
        on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
        factors = linalg.factor_system(A64.float(), w.float())
        assert linalg.factors_dtype(factors) == torch.float32
        x = linalg.lu_solve_refined(A64, factors, h)
        assert x.dtype == torch.float64 and _rel(x, ref_x) <= 1e-11


@pytest.fixture(scope="module")
def ref_solution(ref):
    return sc.solve(
        ref["device"], applied_field=sc.sources.ConstantField(0.5), current_units="uA",
        circulating_currents={"big_hole": "1 uA"}, iterations=2, coupling="exact",
    )


@pytest.mark.parametrize("route", ROUTES)
def test_solve_and_solve_many_through_each_route_match_jax(ref, ref_solution, on_the_card, route):
    """``solve()`` and ``solve_many()`` with every film on ``route`` against
    the JAX package's ``solve()`` (LU on the CPU)."""
    on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    device = ref["port"]
    model = st.factorize_model(
        device=device, current_units="uA", circulating_currents={"big_hole": "1 uA"},
        torch_device="cpu",
    )
    expected = "chol" if route == "chol" else "inv"
    assert {d.fac_kind for d in model.film_data.values()} == {expected}
    solution = st.solve(
        model=model, applied_field=st.sources.ConstantField(0.5), iterations=2, coupling="exact",
        torch_device="cpu",
    )[-1]
    result = st.solve_many(
        model=model, applied_fields=[st.sources.ConstantField(v) for v in (0.25, 0.5)],
        circulating_currents=[{"big_hole": "1 uA"}] * 2, iterations=2, coupling="exact",
        torch_device="cpu",
    )
    for name, fs in ref_solution[-1].film_solutions.items():
        assert _rel(solution.film_solutions[name].stream, fs.stream) <= SOLVE_TOL
        assert _rel(result.streams[name][1], fs.stream) <= SOLVE_TOL


def test_large_factor_chol_gives_cholesky_factors(ref, on_the_card):
    """Fault 3.15: ``SUPERSCREEN_TPU_LARGE_FACTOR=chol`` gave LU factors.
    It now gives ``("chol", L, w)`` with ``w`` the film's interior weights,
    and the default gives ``("inv", M, w)``."""
    for route, tag in (("chol", "chol"), (None, "inv")):
        if route is None:
            on_the_card.delenv("SUPERSCREEN_TPU_LARGE_FACTOR", raising=False)
        else:
            on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
        model = st.factorize_model(device=ref["port"], current_units="uA", torch_device="cpu")
        for name, system in model.film_systems.items():
            kind, factor, w = system.lu_piv
            assert kind == tag and factor.shape == system.A.shape
            ix = torch.as_tensor(system.indices)
            assert torch.equal(w, model.film_info[name].weights[ix])


def _is_lu(factors, n):
    lu, perm = factors
    return lu.shape == (n, n) and sorted(perm.tolist()) == list(range(n))


def test_a_cpu_system_takes_lu_above_the_threshold(system, monkeypatch):
    """On the CPU every system takes LU, with weights or without, as on the
    JAX package's CPU backend; on the card a system of at most
    ``LU_MAX_N_TPU`` unknowns takes LU too, and a larger one without
    weights (an inhomogeneous Lambda) the inverse from its LU."""
    A, w = torch.as_tensor(system["A"]), torch.as_tensor(system["w"])
    n = A.shape[0]
    monkeypatch.setattr(linalg, "LU_MAX_N_TPU", 0)
    for weights in (w, None):
        factors = linalg.factor_system(A, weights)
        assert linalg.factor_kind(factors) == "lu" and _is_lu(factors, n)
    monkeypatch.setattr(linalg, "_on_cpu", lambda A: False)
    for limit in (n, n + 1):
        monkeypatch.setattr(linalg, "LU_MAX_N_TPU", limit)
        for weights in (w, None):
            factors = linalg.factor_system(A, weights)
            assert linalg.factor_kind(factors) == "lu" and _is_lu(factors, n)
    monkeypatch.setattr(linalg, "LU_MAX_N_TPU", n - 1)
    assert linalg.factor_system(A, w)[0] == "inv"
    kind, M, none = linalg.factor_system(A)
    assert kind == "inv" and none is None and M.is_contiguous()


class _LiveBytes(TorchDispatchMode):
    """The most bytes that the storages made by the ops run under it hold
    at once (a storage is alive while a tensor on it is referenced)."""

    def __init__(self, ignore=()):
        super().__init__()
        self.ignore = {t.untyped_storage().data_ptr() for t in ignore}
        self.live = {}
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.live = {
            k: (size, refs) for k, (size, refs) in self.live.items() if any(r() is not None for r in refs)
        }
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage.data_ptr()
            if key in self.ignore or storage.nbytes() == 0:
                continue
            self.live.setdefault(key, (storage.nbytes(), []))[1].append(weakref.ref(t))
        self.peak = max(self.peak, sum(size for size, _ in self.live.values()))
        return out


@pytest.mark.parametrize("route", ROUTES + ["lu_inverse"])
def test_route_memory_within_the_materialized_ceiling(on_the_card, route):
    """Every route holds at most ``LU_PEAK_BUFFERS`` ``(n, n)`` matrices at
    once, the system ``A`` among them, plus panels: every storage its ops
    make is tracked while it lives, with 8-row blocks and panels.  The
    ``"inv"`` and ``"chol"`` routes and the inverse from LU of a system
    without weights (``"lu_inverse"``, with a non-symmetric ``A``) hold one
    matrix beside ``A``."""
    n, width = 256, 8
    on_the_card.setattr(linalg, "FACTOR_BLOCK", width)
    on_the_card.setattr(rows, "PANEL", width)
    on_the_card.setattr(rows, "SCHUR_LEAF", width)
    on_the_card.setattr(rows, "SCHULZ_ITERS", 2)
    if route != "lu_inverse":
        on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    rng = np.random.default_rng(3)
    G = rng.normal(size=(n, n))
    w = torch.as_tensor(0.5 + rng.random(n))
    A = torch.as_tensor((G @ G.T / n + 3.0 * np.eye(n)) * w.numpy()[None, :])
    if route == "lu_inverse":
        A = A + torch.as_tensor(rng.normal(size=(n, n)) / n)
        w = None
    with _LiveBytes(ignore=[A] if w is None else [A, w]) as tracker:
        factors = linalg.factor_system(A, w)
    if route in ("inv", "chol", "schur", "cg", "lu_inverse"):
        x = linalg.lu_solve(factors, torch.ones(n, dtype=A.dtype))
        assert _rel(-(A @ x), np.ones(n)) < 1e-10
    matrix = n * n * 8
    panels = 6 * n * width * 8
    assert panels <= matrix // 5
    beside_A = 1 if route in ("inv", "chol", "lu_inverse") else solve_film.LU_PEAK_BUFFERS - 1
    assert tracker.peak <= beside_A * matrix + panels, tracker.peak / matrix
    assert tracker.peak > (beside_A - 1) * matrix + 0.9 * matrix  # the tracker sees the factor


def _h5():
    h5py = pytest.importorskip("h5py")
    return h5py.File(io.BytesIO(), "w")


@pytest.mark.parametrize("route", ["inv", "chol"])
@pytest.mark.parametrize("pad", [0, 64], ids=["dense", "padded"])
def test_jax_route_films_load_and_solve(system, route, pad):
    """A JAX film system written by its own ``to_hdf5`` with its route's
    factors (padded with a decoupled identity block as a JAX low-memory
    film is, or not) loads with its tag and solves as the JAX package
    does."""
    A, w, h = system["A"], system["w"], system["h"]
    n = A.shape[0]
    A_pad = np.eye(n + pad)
    A_pad[:n, :n] = A
    w_pad = np.concatenate([w, np.ones(pad)])
    jA, jw = jnp.asarray(A_pad), jnp.asarray(w_pad)
    factor = (
        jlinalg._jax_chol_explicit_inverse_from_A(jA, jw) if route == "inv"
        else jlinalg._jax_chol_factor(-jA, jw)
    )
    indices = np.arange(n)
    ref_system = ref_solve_film.LinearSystem(A=A_pad, indices=indices, lu_piv=(route, factor, jw))
    with _h5() as f:
        ref_system.to_hdf5(f)
        loaded = solve_film.LinearSystem.from_hdf5(f, "cpu")
    assert loaded.lu_piv[0] == route and loaded.lu_piv[1].shape == (n, n)
    assert loaded.A.shape == (n, n) and len(loaded.lu_piv[2]) == n
    x = linalg.lu_solve_refined(loaded.A, loaded.lu_piv, torch.as_tensor(h))
    assert _rel(x, jlinalg.lu_solve_refined(A, system["jax"][route], h)) <= FACTOR_TOL


@pytest.mark.parametrize("route", ["inv", "chol"])
def test_port_route_films_load_into_jax(system, on_the_card, route):
    """A port film system with each route's factors, written by the port
    and read by the JAX package: the same solves, and back into the port
    bit for bit."""
    factors = _port_factors(system, route, on_the_card)
    A, h = system["A"], system["h"]
    port_system = solve_film.LinearSystem(A=torch.as_tensor(A), indices=np.arange(len(A)), lu_piv=factors)
    with _h5() as f:
        port_system.to_hdf5(f)
        jax_system = ref_solve_film.LinearSystem.from_hdf5(f)
        again = solve_film.LinearSystem.from_hdf5(f, "cpu")
    assert jax_system.lu_piv[0] == route
    x_jax = jlinalg.lu_solve_refined(jax_system.A, jax_system.lu_piv, h)
    x = linalg.lu_solve_refined(port_system.A, factors, torch.as_tensor(h))
    assert _rel(x, x_jax) <= FACTOR_TOL
    assert all(torch.equal(a, b) for a, b in zip(again.lu_piv[1:], factors[1:]))


@pytest.fixture(scope="module")
def certify_inputs():
    """The float32 two rings of tests/test_certify.py, solved by the JAX
    package (B = 3, two rounds, circulating currents): its film data and
    streams."""
    device = _two_rings("float32")
    model = sc.factorize_model(device=device, current_units="uA")
    data = {name: _film_sweep_data(model, name) for name in device.films}
    B = 3
    Hz = {
        name: np.linspace(0.2, 1.0, B)[:, None].astype(np.float32) * np.ones(d.n, dtype=np.float32)[None, :]
        for name, d in data.items()
    }
    I_circ = {name: np.full((B, len(d.hole_names)), 5.0, dtype=np.float32) for name, d in data.items()}
    streams, _, _, others = _run_sweep(data, Hz, I_circ, 1645.5, 2, 2)
    return dict(model=model, data=data, Hz=Hz, I_circ=I_circ,
                streams={k: np.asarray(v) for k, v in streams.items()},
                others={k: np.asarray(v) for k, v in others.items()})


def _port_data(jax_data, factors):
    """The port's sweep data around the JAX package's own arrays, with the
    port's route factors of its ``A``."""
    from superscreen_tpu_torch import sweep as port_sweep

    def t(a):
        return None if a is None else torch.as_tensor(np.array(a))

    nv = int(np.asarray(jax_data.n_valid))
    empty = torch.zeros((0, 1))
    return port_sweep.FilmSweepData(
        name=jax_data.name, n=int(jax_data.n), interior=t(jax_data.interior)[:nv].long(),
        factors=factors, A=t(jax_data.A)[:nv, :nv].contiguous(), Qw=None,
        weights=t(jax_data.weights), gx_idx=empty.long(), gx_w=empty, gy_idx=empty.long(),
        gy_w=empty, sites=t(jax_data.sites), z0=float(jax_data.z0),
        hole_masks=t(jax_data.hole_masks), hole_ha_vecs=t(jax_data.hole_ha_vecs),
        hole_names=list(jax_data.hole_names), fac_kind=linalg.factor_kind(factors),
    )


@pytest.mark.parametrize("route", ["inv", "chol"])
def test_certificate_of_route_films_matches_jax(certify_inputs, on_the_card, route):
    """``certify_sweep`` and ``refine_sweep_f64`` on films factorized by
    each route, against the JAX package's certificate of the same float32
    systems with its own route factors (``superscreen_tpu/certify.py``
    ``_solve_op``)."""
    on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    ref_data, data = {}, {}
    for name, d in certify_inputs["data"].items():
        nv = int(np.asarray(d.n_valid))
        A = np.asarray(d.A)[:nv, :nv]
        w = np.asarray(d.weights)[np.asarray(d.interior)[:nv]]
        factors = linalg.factor_system(torch.as_tensor(A), torch.as_tensor(w))
        jA, jw = jnp.asarray(A), jnp.asarray(w)
        jax_factor = (
            jlinalg._jax_chol_explicit_inverse_from_A(jA, jw) if route == "inv"
            else jlinalg._jax_chol_factor(-jA, jw)
        )
        assert nv == d.A.shape[0]
        ref_data[name] = dataclasses.replace(d, fac_kind=route, fac_a=jax_factor, fac_b=jw)
        data[name] = _port_data(d, factors)
    args = (certify_inputs["streams"], certify_inputs["others"], certify_inputs["Hz"])
    kwargs = dict(I_circ=certify_inputs["I_circ"], n_sample_rows=64)
    ref = ref_certify.certify_sweep(ref_data, *args, **kwargs)
    port = certify.certify_sweep(data, *args, **kwargs)
    assert port["films_certified"] == ref["films_certified"] == sorted(data)
    np.testing.assert_allclose(port["residual_rel_max"], ref["residual_rel_max"], rtol=1e-6)
    assert port["refined_residual_rel_max"] < 1e-9 and port["sampled_row_rel_disagreement"] < 1e-12
    np.testing.assert_allclose(port["refined_stream_delta_max"], ref["refined_stream_delta_max"], rtol=1e-3)
    polished, report = certify.refine_sweep_f64(data, *args, I_circ=certify_inputs["I_circ"], steps=2,
                                               result_dtype="float64")
    _, ref_report = ref_certify.refine_sweep_f64(ref_data, *args, I_circ=certify_inputs["I_circ"], steps=2,
                                                 result_dtype="float64")
    assert report["residual_rel_max_after"] < 1e-9 and ref_report["residual_rel_max_after"] < 1e-9


@pytest.mark.parametrize("route", ["inv", "chol"])
def test_landscape_diagonal_of_route_films_matches_jax(ref, on_the_card, route):
    """The response diagonal of a film on each route against the JAX
    package's on its own route factors (it reads ``-diag(M)`` of an
    ``"inv"`` film, exact at float64; the port solves the identity
    blocks refined on every form of the factors)."""
    on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    on_the_card.setattr(vortices, "DIAG_BLOCK", 100)
    model = st.factorize_model(device=ref["port"], current_units="uA", torch_device="cpu")
    system = model.film_systems["big_ring"]
    assert linalg.factor_kind(system.lu_piv) == route
    weights = model.film_info["big_ring"].weights
    diag = vortices._response_diagonal(system, weights)
    ref_system = ref["model"].film_systems["big_ring"]
    A = np.asarray(ref_system.A)
    w = np.asarray(ref["model"].film_info["big_ring"].weights)
    jA, jw = jnp.asarray(A), jnp.asarray(w[ref_system.indices])
    factor = (
        jlinalg._jax_chol_explicit_inverse_from_A(jA, jw) if route == "inv"
        else jlinalg._jax_chol_factor(-jA, jw)
    )
    jax_system = dataclasses.replace(ref_system, lu_piv=(route, factor, jw))
    ref_diag = ref_vortices._response_diagonal(jax_system, w)
    assert _rel(diag, ref_diag) <= FACTOR_TOL


@pytest.mark.parametrize("matrix", ["random", "strip"])
@pytest.mark.parametrize("fit", ["divides", "ragged"])
def test_inverse_from_lu_at_any_block(inhomogeneous, matrix, fit):
    """The in-place inverse from the partial-pivot LU equals
    ``numpy.linalg.inv(-A)`` at a block that divides ``n`` and one that
    does not: on a random non-symmetric matrix whose LU swaps rows, and on
    the inhomogeneous strip's system (diagonally dominant: no swaps).  The
    operator is returned row-major,
    in the LU's buffer."""
    if matrix == "random":
        A = np.random.default_rng(5).normal(size=(120, 120))
    else:
        A = inhomogeneous[1]
    n = A.shape[0]
    if matrix == "random":
        _, piv = torch.linalg.lu_factor(torch.as_tensor(A))
        assert bool((piv - 1 != torch.arange(n)).any())
    # The strip's n is prime: the block that divides it is n itself.
    block = next(b for b in range(8, n + 1) if (n % b == 0) == (fit == "divides"))
    M = linalg._lu_explicit_inverse(torch.as_tensor(A), block)
    assert M.is_contiguous() and M.shape == (n, n)
    assert _rel(M, np.linalg.inv(-A)) <= FACTOR_TOL


def _transport_device(dtype="float64"):
    """A coarse terminal strip with a hole and a weak spot in Lambda
    (``chip_smoke.py`` phase 8's shape) under a homogeneous disk."""

    def weak_spot(x, y, x0=1.0, y0=0.5, sigma=1.0, depth=0.5):
        return 1.0 + depth * np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))

    width, height, h = 6.0, 3.0, 0.4
    terminals = [
        st.Polygon(name, points=st.geometry.box(h / 4, height, center=(x, 0)))
        for name, x in (("source", -width / 2), ("drain", width / 2))
    ]
    device = st.Device(
        "terminal_strip",
        layers=[st.Layer("base", Lambda=st.Parameter(weak_spot), z0=0), st.Layer("top", Lambda=1, z0=1)],
        films=[
            st.Polygon("strip", layer="base", points=st.geometry.box(width, height, points=45)),
            st.Polygon("disk", layer="top", points=st.geometry.circle(1.2, points=30, center=(1.5, 0))),
        ],
        holes=[st.Polygon("strip_hole", layer="base", points=st.geometry.circle(0.6, points=10, center=(-1.5, 0)))],
        terminals={"strip": terminals}, solve_dtype=dtype,
    )
    device.make_mesh(min_points=250)
    return device


def _transport_model(device):
    vortices = [st.Vortex(x=1.2, y=0.4, film="strip"), st.Vortex(x=-0.5, y=-0.8, film="strip")]
    return st.factorize_model(device=device, current_units="uA", vortices=vortices, torch_device="cpu")


def _transport_sweep(model):
    """A driven three-point sweep: bias and vortex amplitudes per point,
    two coupling rounds."""
    r = st.solve_many(
        model=model, applied_fields=[st.sources.ConstantField(b) for b in (0.1, 0.4, 0.7)],
        terminal_currents=[{"strip": {"source": I, "drain": -I}} for I in (1.0, 2.5, 4.0)],
        vortex_nPhi0=np.array([[1.0, 0.0], [-1.0, 2.0], [0.0, -2.0]]), iterations=2, coupling="exact",
        torch_device="cpu",
    )
    return r.streams


def _inverted_from_lu(model):
    """The strip's film and bootstrap systems inverted from their LU, the
    disk on the Cholesky route."""
    strip = model.terminal_systems["strip"]
    for system in (model.film_systems["strip"], strip.film_without_boundary):
        assert system.lu_piv[0] == "inv" and system.lu_piv[2] is None
    assert model.film_data["strip"].fac_kind == "inv"
    assert model.film_systems["disk"].lu_piv[2] is not None


def test_transport_sweep_inverted_from_lu_matches_lu(on_the_card):
    """``solve_many`` of an inhomogeneous-Lambda strip with terminals and
    vortices, its systems inverted from their LU, against the same call on
    LU factors, at float64."""
    device = _transport_device()
    on_the_card.setattr(linalg, "LU_MAX_N_TPU", 10**9)
    lu_model = _transport_model(device)
    assert {d.fac_kind for d in lu_model.film_data.values()} == {"lu"}
    on_the_card.setattr(linalg, "LU_MAX_N_TPU", 0)
    model = _transport_model(device)
    _inverted_from_lu(model)
    want, got = _transport_sweep(lu_model), _transport_sweep(model)
    for name in want:
        assert _rel(got[name], want[name]) <= SOLVE_TOL


def test_transport_model_inverted_from_lu_survives_hdf5(on_the_card):
    """A model whose strip is inverted from its LU saves without ``inv_w``
    and loads with the same factors: its sweep is bitwise the same."""
    h5py = pytest.importorskip("h5py")
    model = _transport_model(_transport_device())
    _inverted_from_lu(model)
    buffer = io.BytesIO()
    with h5py.File(buffer, "w") as f:
        model.to_hdf5(f)
        assert "inv_M" in f["film_systems/strip"] and "inv_w" not in f["film_systems/strip"]
        assert "inv_w" in f["film_systems/disk"]
    with h5py.File(buffer, "r") as f:
        loaded = st.FactorizedModel.from_hdf5(f, torch_device="cpu")
    _inverted_from_lu(loaded)
    assert torch.equal(loaded.film_systems["strip"].lu_piv[1], model.film_systems["strip"].lu_piv[1])
    want, got = _transport_sweep(model), _transport_sweep(loaded)
    for name in want:
        assert np.array_equal(got[name], want[name])


@pytest.fixture(scope="module")
def inhomogeneous():
    """A coarse copy of ``chip_smoke.py`` phase 8's strip (20 x 8 with a
    hole, a Gaussian weak spot in Lambda) beside a homogeneous disk: the
    JAX package's device, strip system and weights."""

    def weak_spot(x, y, x0=2.0, y0=1.0, sigma=2.0, depth=0.5, base=1.0):
        return base * (1 + depth * np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2)))

    device = sc.Device(
        "weak_strip",
        layers=[sc.Layer("base", Lambda=sc.Parameter(weak_spot), z0=0), sc.Layer("top", Lambda=1, z0=1)],
        films=[
            sc.Polygon("strip", layer="base", points=geo.box(20, 8, points=60)),
            sc.Polygon("disk", layer="top", points=geo.circle(3, points=40)),
        ],
        holes=[sc.Polygon("hole", layer="base", points=geo.circle(1.5, points=20, center=(-5, 0)))],
        solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.9)
    model = sc.factorize_model(device=device, current_units="uA")
    fs = model.film_systems["strip"]
    assert model.film_info["strip"].lambda_info.inhomogeneous
    w = np.asarray(model.film_info["strip"].weights)[fs.indices]
    return device, np.array(fs.A), w


def test_inhomogeneous_lambda_misses_the_bar_on_the_symmetric_part_and_meets_it_inverted_from_lu(
    inhomogeneous, on_the_card,
):
    """The measurement behind the port's one deviation from the JAX
    package's routes: with a ``(grad Lambda) . grad`` term ``A / w`` is
    not symmetric, and the JAX route's inverse of its symmetric part
    leaves ``||I + M A||`` ~0.3 on the strip: unrefined (the sweep's inner
    rounds) its streams are off by ~8e-2, and after the final round's two
    refinement steps the residual is still above the 1e-4 bar (1.5e-4).
    The inverse of the full system from its LU, the port's route for such
    a film on the card, solves to the float64 floor unrefined and
    refined, as LU's refined solve does.  The route is decided from
    ``lambda_info.inhomogeneous`` before the factorization; the
    homogeneous film of the same device takes the Cholesky route's
    ``"inv"``, with its weights."""
    device, A, w = inhomogeneous
    M = np.asarray(jlinalg._jax_chol_explicit_inverse_from_A(jnp.asarray(A), jnp.asarray(w)))
    h = np.random.default_rng(1).standard_normal((A.shape[0], 4))
    x_lu = np.linalg.solve(-A, h)
    x = M @ h
    assert _rel(x, x_lu) > 1e-2
    for _ in range(2):
        x = x + M @ (h + A @ x)
    residual = np.linalg.norm(h + A @ x) / np.linalg.norm(h)
    assert residual > RESIDUAL_BAR, residual
    inverse = linalg.factor_system(torch.as_tensor(A))
    assert inverse[0] == "inv" and inverse[2] is None
    assert np.linalg.norm(np.eye(len(A)) + inverse[1].numpy() @ A) < 1e-10
    assert _rel(linalg.lu_solve(inverse, torch.as_tensor(h)), x_lu) < 1e-10
    on_the_card.setattr(linalg, "_on_cpu", lambda A: True)
    lu = linalg.factor_system(torch.as_tensor(A))
    assert linalg.factor_kind(lu) == "lu"
    on_the_card.setattr(linalg, "_on_cpu", lambda A: False)
    for factors in (inverse, lu):
        x = linalg.lu_solve_refined(torch.as_tensor(A), factors, torch.as_tensor(h)).numpy()
        assert np.linalg.norm(h + A @ x) / np.linalg.norm(h) < 1e-12
    model = st.factorize_model(device=st.device_from_reference(device), current_units="uA",
                               torch_device="cpu")
    assert model.film_data["strip"].fac_kind == "inv" and model.film_systems["strip"].lu_piv[2] is None
    assert model.film_data["disk"].fac_kind == "inv"
    disk = model.film_systems["disk"]
    assert torch.equal(disk.lu_piv[2], model.film_info["disk"].weights[torch.as_tensor(disk.indices)])


@pytest.mark.parametrize("route", ["inv", "schur"])
def test_materialized_ceiling_derives_from_the_route(ref, on_the_card, route):
    """The low-memory dense ceiling holds ``MAX_MATERIALIZED_BYTES`` at the
    route's peak: three matrices for LU, ``"inv"`` and ``"chol"``, four for
    ``"schur"`` and ``"schulz"`` (three row blocks and panels); a film whose
    interior is above it is left to CG."""
    on_the_card.delenv("SUPERSCREEN_TPU_MAX_MATERIALIZED_N", raising=False)
    lu_max = solve_film.max_materialized_n(torch.float32)
    assert lu_max == 75000
    four = solve_film.max_materialized_n(torch.float32, solve_film.INVERSE_PEAK_BUFFERS)
    assert solve_film.INVERSE_PEAK_BUFFERS * four**2 * 4 <= solve_film.MAX_MATERIALIZED_BYTES < (
        solve_film.INVERSE_PEAK_BUFFERS * (four + 1) ** 2 * 4
    )
    seen = []

    def recorded(dtype, buffers=solve_film.LU_PEAK_BUFFERS):
        seen.append(buffers)
        return 10**9

    on_the_card.setattr(solve_film, "max_materialized_n", recorded)
    on_the_card.setattr(st.solver.utils, "MAX_DENSE_KERNEL_SIZE", 10)
    on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    model = st.factorize_model(device=ref["port"], current_units="uA", torch_device="cpu")
    assert not any(info.dense_kernel for info in model.film_info.values())
    expected = solve_film.INVERSE_PEAK_BUFFERS if route == "schur" else solve_film.LU_PEAK_BUFFERS
    assert seen == [expected] * 2


@pytest.mark.parametrize("route", ["inv", "chol"])
def test_consumers_of_the_factors_match_jax(ref, on_the_card, route):
    """The consumers that solve through ``lu_solve`` take each form of the
    factors: ``mutual_inductance_matrix``, ``find_fluxoid_solution`` and
    ``solve_film`` through the route against the JAX package's (LU on the
    CPU), at the bars of tests/test_torch_fluxoid.py and
    tests/test_torch_solve_film.py."""
    on_the_card.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    device, port = ref["device"], ref["port"]
    expected = device.mutual_inductance_matrix(iterations=2)
    got = port.mutual_inductance_matrix(iterations=2, torch_device="cpu")
    np.testing.assert_allclose(
        np.asarray(got.magnitude), np.asarray(expected.magnitude), rtol=0,
        atol=SOLVE_TOL * np.abs(np.asarray(expected.magnitude)).max(),
    )
    targets = {"big_hole": 1, "little_hole": -2}
    model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    assert {d.fac_kind for d in model.film_data.values()} == {route}
    fluxoid = st.find_fluxoid_solution(
        model, targets, applied_field=st.sources.ConstantField(0.05), iterations=2,
        torch_device="cpu",
    )
    ref_fluxoid = sc.find_fluxoid_solution(
        ref["model"], targets, applied_field=sc.sources.ConstantField(0.05), iterations=2
    )
    for hole, current in ref_fluxoid.circulating_currents.items():
        assert abs(fluxoid.circulating_currents[hole] - current) <= 1e-6 * abs(current)
    name = "big_ring"
    kwargs = dict(applied_field=np.full(len(device.meshes[name].sites), 0.5), field_conversion=1.0,
                  vortex_flux=1.0)
    got = solve_film.solve_film(
        device=port, film_info=model.film_info[name], film_system=model.film_systems[name],
        hole_systems=model.hole_systems[name], **kwargs,
    )
    want = ref_solve_film.solve_film(
        device=device, film_info=ref["model"].film_info[name],
        film_system=ref["model"].film_systems[name], hole_systems=ref["model"].hole_systems[name],
        **kwargs,
    )
    assert _rel(got.stream, want.stream) <= SOLVE_TOL

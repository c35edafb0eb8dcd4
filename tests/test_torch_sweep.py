"""The port's ``solve_many`` against ``superscreen_tpu.sweep.solve_many`` on
the same device and mesh (through ``device_from_reference``), at float64 on
the CPU, plus the sweep's own contracts."""

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu.solver import utils as ref_utils
from superscreen_tpu.sweep import solve_many as ref_solve_many
from superscreen_tpu_torch import sweep as port_sweep
from superscreen_tpu_torch.solver import utils as port_utils

torch.set_num_threads(2)

# float64 on both sides; LU pivoting and summation orders differ, which
# costs a few ulp times the systems' condition numbers (~1e3-1e4).
RTOL = 1e-8
# The CG solves stop at a relative residual of 1e-6.
CG_RTOL = 1e-5
QUANTITIES = ["streams", "current_densities", "self_fields", "applied_fields", "other_fields"]
CIRC = {"big_hole": 10.0, "little_hole": -5.0}


def _two_rings():
    """The two-ring device of tests/test_sweep.py."""
    layers = [sc.Layer("layer0", Lambda=1, z0=0), sc.Layer("layer1", Lambda=1, z0=1)]
    films = [
        sc.Polygon("big_ring", layer="layer0", points=geo.circle(7.5, points=80)),
        sc.Polygon("little_ring", layer="layer1", points=geo.circle(5, points=60)),
    ]
    holes = [
        sc.Polygon("big_hole", layer="layer0", points=geo.circle(3.75, points=40)),
        sc.Polygon("little_hole", layer="layer1", points=geo.circle(2.5, points=30)),
    ]
    device = sc.Device("two_rings", layers=layers, films=films, holes=holes, solve_dtype="float64")
    device.make_mesh(max_edge_length=0.9)
    return device


def _max_rel(a, b):
    """Largest difference relative to max|b| (0 where both are all zero)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _fields(module, values):
    return [module.sources.ConstantField(v) for v in values]


def _arrays(device, B):
    return {
        name: np.ones((B, len(mesh.sites))) * np.linspace(0.1, 1, B)[:, None]
        for name, mesh in device.meshes.items()
    }


def _assert_results_match(port_result, ref_result, quantities=QUANTITIES, rtol=RTOL):
    assert len(port_result) == len(ref_result)
    for quantity in quantities:
        ref_arrays = getattr(ref_result, quantity)
        port_arrays = getattr(port_result, quantity)
        if ref_arrays is None:
            assert port_arrays is None, quantity
            continue
        for name, a in ref_arrays.items():
            b = port_arrays[name]
            assert isinstance(b, np.ndarray) and b.shape == np.shape(a), (quantity, name)
            assert _max_rel(b, a) <= rtol, (quantity, name, _max_rel(b, a))


@pytest.fixture(scope="module")
def devices():
    ref = _two_rings()
    return ref, st.device_from_reference(ref)


@pytest.fixture(scope="module")
def models(devices):
    ref, port = devices
    return (
        sc.factorize_model(device=ref, current_units="uA"),
        st.factorize_model(device=port, current_units="uA", torch_device="cpu"),
    )


def test_meshes_are_small(devices):
    assert all(100 < len(m.sites) < 1500 for m in devices[0].meshes.values())


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_fields_and_currents_sweep_matches_jax(models, quantity):
    ref_model, model = models
    kwargs = dict(circulating_currents=[CIRC] * 2, iterations=2)
    ref = ref_solve_many(
        model=ref_model, applied_fields=_fields(sc, [0.5, 2.0]), coupling="exact", **kwargs
    )
    result = st.solve_many(
        model=model, applied_fields=_fields(st, [0.5, 2.0]), torch_device="cpu", **kwargs
    )
    _assert_results_match(result, ref, [quantity])


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_applied_field_arrays_sweep_matches_jax(devices, models, quantity):
    ref_model, model = models
    arrays = _arrays(devices[0], 3)
    ref = ref_solve_many(
        model=ref_model, applied_field_arrays=arrays, iterations=1, coupling="exact"
    )
    result = st.solve_many(
        model=model, applied_field_arrays=arrays, iterations=1, torch_device="cpu"
    )
    assert len(result) == 3
    _assert_results_match(result, ref, [quantity])


def test_applied_field_arrays_as_tensors_and_linearity(devices, models):
    _, model = models
    arrays = _arrays(devices[0], 3)
    from_numpy = st.solve_many(
        model=model, applied_field_arrays=arrays, iterations=1, torch_device="cpu"
    )
    tensors = {name: torch.as_tensor(a, dtype=torch.float32) for name, a in arrays.items()}
    from_tensors = st.solve_many(
        model=model, applied_field_arrays=tensors, iterations=1, torch_device="cpu"
    )
    for name, s in from_numpy.streams.items():
        # The tensors carried float32 fields.
        assert _max_rel(from_tensors.streams[name], s) <= 1e-6
        # No circulating currents: the problem is linear in the field.
        assert np.allclose(s[2], 10 * s[0], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("iteration", [0, 1, 2])
def test_keep_history_matches_jax(models, iteration):
    ref_model, model = models
    ref = ref_solve_many(
        model=ref_model, applied_fields=_fields(sc, [0.3, 0.8]), iterations=2,
        keep_history=True, coupling="exact",
    )
    history = st.solve_many(
        model=model, applied_fields=_fields(st, [0.3, 0.8]), iterations=2,
        keep_history=True, torch_device="cpu",
    )
    assert isinstance(history, list) and len(history) == len(ref) == 3
    _assert_results_match(history[iteration], ref[iteration])


def test_history_ends_at_the_final_state_sweep(models):
    _, model = models
    kwargs = dict(model=model, applied_fields=_fields(st, [0.3, 0.8]), iterations=2,
                  torch_device="cpu")
    history = st.solve_many(keep_history=True, **kwargs)
    final = st.solve_many(**kwargs)
    # The final-state sweep refines its inner rounds 0 times; at float64
    # an unrefined LU solve is already at ~1e-12.
    _assert_results_match(final, history[-1], rtol=1e-9)


def test_inner_refine_override(models, monkeypatch, caplog):
    ref_model, model = models
    kwargs = dict(iterations=3)
    fast = st.solve_many(
        model=model, applied_fields=_fields(st, [1.0]), torch_device="cpu", **kwargs
    )
    assert port_sweep._inner_refine_steps(2) == 0
    monkeypatch.setenv("SUPERSCREEN_TPU_INNER_REFINE", "2")
    assert port_sweep._inner_refine_steps(2) == 2
    full = st.solve_many(
        model=model, applied_fields=_fields(st, [1.0]), torch_device="cpu", **kwargs
    )
    ref = ref_solve_many(
        model=ref_model, applied_fields=_fields(sc, [1.0]), coupling="exact", **kwargs
    )
    _assert_results_match(full, ref)
    _assert_results_match(fast, full, rtol=1e-9)
    monkeypatch.setenv("SUPERSCREEN_TPU_INNER_REFINE", "5")
    with caplog.at_level("WARNING", logger="solve"):
        assert port_sweep._inner_refine_steps(2) == 2
    assert "clamped" in caplog.text


@pytest.mark.parametrize("result_dtype", ["float32", "float64"])
def test_result_dtype(models, result_dtype):
    ref_model, model = models
    ref = ref_solve_many(
        model=ref_model, applied_fields=_fields(sc, [0.5]), iterations=1,
        result_dtype=result_dtype, coupling="exact",
    )
    result = st.solve_many(
        model=model, applied_fields=_fields(st, [0.5]), iterations=1,
        result_dtype=result_dtype, torch_device="cpu",
    )
    for quantity in ("streams", "current_densities", "self_fields"):
        for name, a in getattr(result, quantity).items():
            assert a.dtype == np.dtype(result_dtype) == np.asarray(getattr(ref, quantity)[name]).dtype
    _assert_results_match(result, ref, rtol=1e-6 if result_dtype == "float32" else RTOL)


@pytest.mark.parametrize(
    "index, round_",
    [(0, None), (1, None)] + [(index, r) for index in (0, 1) for r in range(3)],
    ids=["0", "1"] + [f"{index}-round{r}" for index in (0, 1) for r in range(3)],
)
def test_sweep_point_matches_the_port_solve(devices, models, index, round_):
    """A sweep point against ``solve()`` on the same drive: the final state
    (``round_`` None), or one round of ``solve()``'s against the same round
    of ``solve_many(keep_history=True)``."""
    _, model = models
    values = [0.5, 2.0]
    model.set_circulating_currents(CIRC)
    try:
        solutions = st.solve(
            model=model, applied_field=st.sources.ConstantField(values[index]),
            iterations=2, torch_device="cpu",
        )
    finally:
        model.set_circulating_currents({})
    result = st.solve_many(
        model=model, applied_fields=_fields(st, values), circulating_currents=[CIRC] * 2,
        iterations=2, keep_history=round_ is not None, torch_device="cpu",
    )
    if round_ is None:
        solution, point = solutions[-1], result.solution(index)
    else:
        assert len(solutions) == len(result) == 3
        solution, point = solutions[round_], result[round_].solution(index)
    for name, fs in solution.film_solutions.items():
        for field in ("stream", "current_density", "self_field", "field_from_other_films"):
            a = getattr(point.film_solutions[name], field)
            if round_ == 0 and field == "field_from_other_films":
                # The first round sees only the applied field.
                assert fs.field_from_other_films is None and not np.any(a), name
                continue
            assert _max_rel(a, getattr(fs, field)) <= 1e-9, (name, field)


def test_solution_materializes_every_field(models):
    ref_model, model = models
    ref = ref_solve_many(
        model=ref_model, applied_fields=_fields(sc, [0.5, 2.0]),
        circulating_currents=[CIRC, {}], iterations=1, coupling="exact",
    )
    result = st.solve_many(
        model=model, applied_fields=_fields(st, [0.5, 2.0]),
        circulating_currents=[CIRC, {}], iterations=1, torch_device="cpu",
    )
    assert result.num_solutions == len(result.solutions()) == 2
    for i in range(2):
        a, b = ref.solution(i), result.solution(i)
        assert isinstance(b, st.Solution) and b.solver == "superscreen_tpu_torch.solve_many"
        assert b.circulating_currents == a.circulating_currents
        assert b.field_units == a.field_units and b.current_units == a.current_units
        assert b.applied_field_func(0.0, 0.0, 0.0) == [0.5, 2.0][i]
        assert b.terminal_currents == {} and b.vortices == []
        for name, fs in a.film_solutions.items():
            for field in ("stream", "current_density", "applied_field", "self_field",
                          "field_from_other_films", "total_field"):
                assert _max_rel(getattr(b.film_solutions[name], field), getattr(fs, field)) <= RTOL
        # The materialized arrays are copies.
        b.film_solutions["big_ring"].stream[:] = 0.0
        assert np.abs(result.streams["big_ring"][i]).max() > 0


def test_single_film_and_no_iterations_have_no_other_fields(models):
    _, model = models
    result = st.solve_many(model=model, applied_fields=_fields(st, [0.5]), torch_device="cpu")
    assert result.other_fields is None
    assert result.solution(0).film_solutions["big_ring"].field_from_other_films is None


@pytest.mark.parametrize(
    "kwargs, error, match",
    [
        (dict(), ValueError, "exactly one"),
        (dict(applied_fields="fields", applied_field_arrays={"big_ring": np.zeros((1, 10))}),
         ValueError, "exactly one"),
        (dict(applied_fields="fields", circulating_currents=[{}, {}]), ValueError, "length"),
        (dict(applied_field_arrays={"big_ring": np.zeros((1, 10)), "little_ring": np.zeros((1, 10))}),
         ValueError, "shape"),
        (dict(applied_fields="fields", vortices=[]), ValueError, "vortices must be None"),
        (dict(applied_fields="fields", final_refine=1, keep_history=True), ValueError, "keep_history"),
        (dict(applied_fields="fields", result_dtype="float64", keep_history=True), ValueError,
         "keep_history"),
        (dict(applied_fields="fields", coupling="bogus"), ValueError, "coupling"),
        (dict(applied_fields="fields", vortex_nPhi0=np.ones((1, 1))), ValueError, "shape"),
        (dict(applied_fields="fields", terminal_currents=[{"big_ring": {"a": 1.0}}]), ValueError,
         "terminals"),
    ],
)
def test_validation_errors(models, kwargs, error, match):
    _, model = models
    if kwargs.get("applied_fields") == "fields":
        kwargs = dict(kwargs, applied_fields=_fields(st, [0.0]))
    with pytest.raises(error, match=match):
        st.solve_many(model=model, torch_device="cpu", **kwargs)


def test_batch_sizes_must_agree(devices, models):
    _, model = models
    arrays = _arrays(devices[0], 3)
    arrays["little_ring"] = arrays["little_ring"][:2]
    with pytest.raises(ValueError, match="batch size"):
        st.solve_many(model=model, applied_field_arrays=arrays, torch_device="cpu")


def test_device_and_model_arguments(devices, models):
    _, port = devices
    _, model = models
    with pytest.raises(ValueError, match="model or a device"):
        st.solve_many(applied_fields=_fields(st, [0.0]), torch_device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        st.solve_many(model=model, applied_fields=_fields(st, [0.0]), torch_device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            st.solve_many(port, applied_fields=_fields(st, [0.0]))
    from_device = st.solve_many(port, applied_fields=_fields(st, [0.7]), torch_device="cpu")
    from_model = st.solve_many(model=model, applied_fields=_fields(st, [0.7]), torch_device="cpu")
    _assert_results_match(from_device, from_model, rtol=1e-12)


def _lowmem(mp):
    mp.setattr(ref_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    mp.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)


@pytest.fixture(scope="module", params=["lu", "cg"])
def lowmem_sweeps(request, devices):
    ref, port = devices
    arrays = _arrays(ref, 3)
    circ = [CIRC, {}, {"big_hole": -3.0}]
    with pytest.MonkeyPatch.context() as mp:
        _lowmem(mp)
        if request.param == "cg":
            mp.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "cg")
        ref_result = ref_solve_many(
            ref, applied_field_arrays=arrays, circulating_currents=circ, iterations=2,
            coupling="exact",
        )
        model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
        result = st.solve_many(
            model=model, applied_field_arrays=arrays, circulating_currents=circ, iterations=2,
            torch_device="cpu",
        )
    return request.param, model, ref_result, result


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_low_memory_sweep_matches_jax(lowmem_sweeps, quantity):
    kind, model, ref_result, result = lowmem_sweeps
    for data in model.film_data.values():
        assert data.Qw is None and data.fac_kind == kind
    _assert_results_match(result, ref_result, [quantity], rtol=RTOL if kind == "lu" else CG_RTOL)


@pytest.mark.parametrize("columns", [1, 2, 8, 11])
def test_system_residual_accumulates_float32_batches_in_float64(models, columns):
    """The refinement residual ``h + A x`` cancels heavily, so for a float32
    system it is accumulated in float64 from one right-hand side on: its
    error is then the rounding of the result, not of the products."""
    from superscreen_tpu_torch.ops import kernels, linalg

    _, model = models
    data = model.film_data["big_ring"]
    A64 = data.A
    rng = np.random.default_rng(columns)
    x64 = torch.as_tensor(rng.uniform(0.5, 1.5, (A64.shape[0], columns)))
    h64 = -(A64 @ x64) * (1 + 1e-4 * torch.as_tensor(rng.standard_normal(x64.shape)))
    exact = h64 + A64 @ x64
    A, h, x = A64.float(), h64.float(), x64.float()
    exact32 = h.double() + A.double() @ x.double()
    r = linalg.system_residual(A, h, x)
    assert r.dtype == torch.float32 and r.shape == h.shape
    plain = h + A @ x
    err = float((r.double() - exact32).abs().max() / exact32.abs().max())
    err_plain = float((plain.double() - exact32).abs().max() / exact32.abs().max())
    assert err <= 1e-6 and err < err_plain
    # A float64 system takes the plain product.
    assert torch.equal(linalg.system_residual(A64, h64, x64), exact)
    # Blocks smaller than the system give the same rows.
    blocked = kernels.residual_f64_plain(A, x.double(), h, block=97)
    torch.testing.assert_close(blocked.float(), r, rtol=1e-6, atol=0)

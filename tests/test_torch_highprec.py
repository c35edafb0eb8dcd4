"""The port's high-precision mode (``solve(high_precision=True)``, the
float64 systems of ``solver/refine.py``, ``check_inversion``) against
``superscreen_tpu``'s on the same float32 devices and meshes, on the CPU:
the cases of ``tests/test_highprec.py``.  Both packages refine to the
float64 solution of the same float64 systems, so they agree far below
float32 rounding."""

import logging
from dataclasses import replace

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.solver.refine import build_hp_system as ref_build_hp_system
from superscreen_tpu_torch.ops import linalg
from superscreen_tpu_torch.solver import refine
from superscreen_tpu_torch.solver import utils as port_utils

torch.set_num_threads(2)

# Streams, current densities and fields of the two packages' high-precision
# solves: float64 sums in other orders, amplified by the systems'
# conditioning (the JAX tests hold their own mode to 1e-9 of a float64
# solve).
HP_RTOL = 1e-9
# Entries of the float64 systems: the same formulas, rsqrt cubed here and
# a division by d^2 sqrt(d^2) there.
SYSTEM_RTOL = 1e-10


def _ring_device():
    device = sc.Device(
        "ring",
        layers=[sc.Layer("base", Lambda=0.8, z0=0)],
        films=[sc.Polygon("disk", layer="base", points=sc.geometry.circle(5, points=70))],
        holes=[sc.Polygon("hole", layer="base", points=sc.geometry.circle(1.5, points=36))],
        solve_dtype="float32",
    )
    device.make_mesh(min_points=500)
    return device


def _two_film_device():
    device = sc.Device(
        "pair",
        layers=[sc.Layer("l0", Lambda=0.5, z0=0), sc.Layer("l1", Lambda=1.0, z0=0.8)],
        films=[
            sc.Polygon("ring0", layer="l0", points=sc.geometry.circle(5, points=60)),
            sc.Polygon("disk1", layer="l1", points=sc.geometry.circle(3.5, points=50)),
        ],
        holes=[sc.Polygon("hole0", layer="l0", points=sc.geometry.circle(2, points=30))],
        solve_dtype="float32",
    )
    device.make_mesh(min_points=450)
    return device


def _strip_device():
    device = sc.Device(
        "strip",
        layers=[sc.Layer("base", Lambda=1.0, z0=0)],
        films=[sc.Polygon("strip", layer="base", points=sc.geometry.box(4, 2))],
        holes=[sc.Polygon("strip_hole", layer="base", points=sc.geometry.circle(0.4))],
        terminals={
            "strip": [
                sc.Polygon("source", points=sc.geometry.box(0.1, 1.5)).translate(-2, 0),
                sc.Polygon("drain", points=sc.geometry.box(0.1, 1.5)).translate(2, 0),
            ]
        },
        solve_dtype="float32",
    )
    device.make_mesh(min_points=500)
    return device


def _rel_err(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


CASES = {
    "one_film": (
        _ring_device,
        dict(field=0.7, circulating_currents={"hole": "1 mA"}),
    ),
    "coupled_films_with_vortex": (
        _two_film_device,
        dict(field=0.4, circulating_currents={"hole0": "0.5 mA"}, iterations=3,
             vortices=[(0.5, 0.8, "disk1")]),
    ),
    "transport_strip": (
        _strip_device,
        dict(field=0.2, circulating_currents={"strip_hole": "0.3 mA"},
             terminal_currents={"strip": {"source": "1 mA", "drain": "-1 mA"}}),
    ),
}


@pytest.fixture(scope="module", params=list(CASES))
def hp_solutions(request):
    """The last solution of both packages' ``solve(high_precision=True)``
    on the same float32 device."""
    build, spec = CASES[request.param]
    spec = dict(spec)
    ref_device = build()
    field = spec.pop("field")
    vortices = spec.pop("vortices", [])
    ref = sc.solve(
        device=ref_device, applied_field=sc.sources.ConstantField(field), field_units="mT",
        vortices=[sc.Vortex(x=x, y=y, film=f) for x, y, f in vortices],
        high_precision=True, progress_bar=False, **spec,
    )[-1]
    port = st.solve(
        st.device_from_reference(ref_device), applied_field=st.sources.ConstantField(field),
        field_units="mT", vortices=[st.Vortex(x=x, y=y, film=f) for x, y, f in vortices],
        high_precision=True, torch_device="cpu", **spec,
    )[-1]
    return ref, port


@pytest.mark.parametrize(
    "quantity", ["stream", "current_density", "self_field", "field_from_other_films"]
)
def test_high_precision_solve_matches_jax(hp_solutions, quantity):
    ref, port = hp_solutions
    for name, ref_fs in ref.film_solutions.items():
        a, b = getattr(ref_fs, quantity), getattr(port.film_solutions[name], quantity)
        if a is None:
            assert b is None
            continue
        assert b.dtype == np.float64
        assert _rel_err(b, a) < HP_RTOL, (name, quantity, _rel_err(b, a))


@pytest.fixture(scope="module")
def strip_systems():
    """The float64 systems of both packages for the transport strip (a
    dense film with a hole and terminals: every block exists)."""
    ref_device = _strip_device()
    currents = {"strip": {"source": "1 mA", "drain": "-1 mA"}}
    ref_model = sc.factorize_model(
        device=ref_device, current_units="mA", terminal_currents=currents
    )
    ref = ref_build_hp_system(
        ref_device, ref_model.film_info["strip"], ref_model.film_systems["strip"],
        terminal_systems=ref_model.terminal_systems["strip"],
    )
    model = st.factorize_model(
        device=st.device_from_reference(ref_device), current_units="mA",
        terminal_currents=currents, torch_device="cpu",
    )
    return ref, refine.get_hp_systems(model)["strip"], model


@pytest.mark.parametrize(
    "block",
    ["A64", "Lambda64", "weights64", "brandt_diag64", "boundary_eff64", "fwb_A64", "fwboh_A64"],
)
def test_hp_system_blocks_match_jax(strip_systems, block):
    ref, port, _ = strip_systems
    a, b = getattr(ref, block), getattr(port, block)
    assert b.dtype == torch.float64
    np.testing.assert_allclose(b.numpy(), a, rtol=SYSTEM_RTOL, atol=1e-12 * np.abs(a).max())


def test_hp_system_hole_blocks_and_indices_match_jax(strip_systems):
    ref, port, _ = strip_systems
    np.testing.assert_array_equal(port.indices, ref.indices)
    assert set(port.hole_eff64) == set(ref.hole_eff64) == {"strip_hole"}
    a = ref.hole_eff64["strip_hole"]
    np.testing.assert_allclose(
        port.hole_eff64["strip_hole"].numpy(), a, rtol=SYSTEM_RTOL, atol=1e-12 * np.abs(a).max()
    )
    assert port.stats["assembly_s"] > 0


def test_hp_systems_are_float64_twins_of_the_float32_systems(strip_systems):
    """The float64 system is the same system at float64, not the float32
    one widened: they differ by float32 rounding, and no less."""
    _, port, model = strip_systems
    A32 = model.film_systems["strip"].A
    assert A32.dtype == torch.float32
    diff = float((port.A64 - A32.double()).abs().max() / port.A64.abs().max())
    assert 1e-9 < diff < 1e-6
    # The twin keeps the float32 factors.
    hp = model.hp_model
    assert hp.film_systems["strip"].lu_piv[0].dtype == torch.float32
    assert hp.film_data["strip"].A.dtype == torch.float64
    assert hp.film_data["strip"].factors[0] is model.film_data["strip"].factors[0]


def test_hp_model_is_cached_and_follows_the_drive_state():
    device = st.device_from_reference(_ring_device())
    model = st.factorize_model(device=device, current_units="mA", torch_device="cpu")
    first = refine.get_hp_systems(model)
    assert refine.get_hp_systems(model) is first
    assert refine.get_hp_model(model) is model.hp_model
    model.set_circulating_currents({"hole": 2.0})
    assert refine.get_hp_model(model).circulating_currents == {"hole": 2.0}
    a = st.solve(model=model, high_precision=True, torch_device="cpu")[-1]
    model.set_circulating_currents({"hole": 1.0})
    b = st.solve(model=model, high_precision=True, torch_device="cpu")[-1]
    np.testing.assert_allclose(
        a.film_solutions["disk"].stream, 2 * b.film_solutions["disk"].stream, rtol=1e-12
    )


def test_build_hp_system_matches_the_float64_assembly():
    """A64 equals the solver's own system of a float64 copy of the device."""
    ref_device = _ring_device()
    device = st.device_from_reference(ref_device)
    model = st.factorize_model(device=device, current_units="mA", torch_device="cpu")
    hp = refine.build_hp_system(device, model.film_info["disk"], model.film_systems["disk"])
    device64 = device.copy()
    device64.solve_dtype = "float64"
    model64 = st.factorize_model(device=device64, current_units="mA", torch_device="cpu")
    assert torch.equal(hp.A64, model64.film_systems["disk"].A)
    assert torch.equal(hp.hole_eff64["hole"], model64.hole_systems["disk"]["hole"].A)


def test_low_memory_film_high_precision_matches_float64(monkeypatch):
    """A low-memory film materializes only its interior system; its float64
    twin must be that system at float64 (diagonal from the full site set)."""
    monkeypatch.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    device = st.device_from_reference(_two_film_device())
    kwargs = dict(
        applied_field=st.sources.ConstantField(0.4), circulating_currents={"hole0": "0.5 mA"},
        iterations=2, torch_device="cpu",
    )
    hp = st.solve(device, high_precision=True, **kwargs)[-1]
    device64 = device.copy()
    device64.solve_dtype = "float64"
    exact = st.solve(device64, **kwargs)[-1]
    for name, fs in exact.film_solutions.items():
        got = hp.film_solutions[name]
        for quantity in ("stream", "current_density", "self_field", "field_from_other_films"):
            assert _rel_err(getattr(got, quantity), getattr(fs, quantity)) < HP_RTOL, (name, quantity)


def test_matrix_free_film_raises_by_name(monkeypatch):
    monkeypatch.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    monkeypatch.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "cg")
    device = st.device_from_reference(_ring_device())
    with pytest.raises(ValueError, match="'disk' is solved matrix-free"):
        st.solve(device, high_precision=True, torch_device="cpu")


def test_refined_solve_reaches_the_float64_floor_on_an_ill_conditioned_system(caplog):
    rng = np.random.default_rng(1)
    n = 300
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # -A symmetric positive definite with condition number 1e5.
    A64 = torch.as_tensor(-(U * np.logspace(0, 5, n)) @ U.T)
    h = torch.as_tensor(rng.standard_normal((n, 3)))
    exact = torch.linalg.solve(-A64, h)
    lu32 = linalg.factor_system(A64.float())
    precond = linalg.mixed_preconditioner(lu32, torch.float64)
    x32 = precond(h)
    x = refine.refined_solve(A64, precond, h)
    assert x.shape == h.shape and x.dtype == torch.float64
    # Forward error cond * eps_f64 ~ 1e-11, against ~1e-3 of the float32 solve.
    assert _rel_err(x, exact) < 1e-9
    assert _rel_err(x, exact) < 1e-4 * _rel_err(x32, exact)
    one = refine.refined_solve(A64, precond, h[:, 0])
    assert one.shape == (n,) and _rel_err(one, exact[:, 0]) < 1e-9
    # lu_solve_refined takes that route for float64 A with float32 factors.
    assert _rel_err(linalg.lu_solve_refined(A64, lu32, h), exact) < 1e-9
    # A preconditioner that does not contract stalls: the best iterate is
    # returned and the stall is logged.
    with caplog.at_level(logging.WARNING, logger="solve"):
        stalled = refine.refined_solve(A64, lambda r: 0.0 * r, h)
    assert "High-precision refinement stalled" in caplog.text
    assert torch.equal(stalled, torch.zeros_like(h))


@pytest.fixture(scope="module")
def ring_model():
    device = st.device_from_reference(_ring_device())
    return st.factorize_model(
        device=device, current_units="uA", circulating_currents={"hole": "1 mA"},
        torch_device="cpu",
    )


@pytest.mark.parametrize("high_precision", [False, True])
def test_check_inversion_is_silent_on_a_sound_model(ring_model, caplog, high_precision):
    with caplog.at_level(logging.WARNING, logger="solve"):
        st.solve(
            model=ring_model, applied_field=st.sources.ConstantField(0.7), check_inversion=True,
            high_precision=high_precision, torch_device="cpu",
        )
    assert "Unable to solve" not in caplog.text


def test_check_inversion_warns_on_a_corrupted_lu(ring_model, caplog):
    model = ring_model.copy()
    data = model.film_data["disk"]
    lu, perm = data.factors
    corrupted = lu.clone()
    corrupted.diagonal().mul_(1.5)
    model.film_data = {"disk": replace(data, factors=(corrupted, perm))}
    field = st.sources.ConstantField(0.7)
    with caplog.at_level(logging.WARNING, logger="solve"):
        st.solve(model=model, applied_field=field, torch_device="cpu")
    assert "Unable to solve" not in caplog.text  # not asked for
    with caplog.at_level(logging.WARNING, logger="solve"):
        st.solve(model=model, applied_field=field, check_inversion=True, torch_device="cpu")
    assert "Unable to solve for stream function in 'disk', maximum error" in caplog.text


def test_high_precision_mutual_inductance_matches_float64():
    """Mutuals through the per-column high-precision loop match the
    batched float64 path (the JAX test's tolerance)."""
    device = st.device_from_reference(_two_film_device())
    M_hp = device.mutual_inductance_matrix(
        units="pH", iterations=2, high_precision=True, torch_device="cpu"
    )
    device64 = device.copy()
    device64.solve_dtype = "float64"
    M_64 = device64.mutual_inductance_matrix(units="pH", iterations=2, torch_device="cpu")
    np.testing.assert_allclose(M_hp.magnitude, M_64.magnitude, rtol=1e-6)

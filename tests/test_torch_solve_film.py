"""``solver.solve_film.solve_film`` in the port against the JAX package's, on
the same meshes (through ``device_from_reference``) at float64 on the CPU:
each package's own film info and systems, one film, one drive, called as
``tests/test_reference_parity.py`` calls the JAX function."""

import importlib
import logging

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.solver import utils as ref_utils
from superscreen_tpu.solver.refine import build_hp_system as ref_build_hp_system
from superscreen_tpu_torch.solver import refine
from superscreen_tpu_torch.solver import utils as port_utils

ref_sf = importlib.import_module("superscreen_tpu.solver.solve_film")
port_sf = importlib.import_module("superscreen_tpu_torch.solver.solve_film")

torch.set_num_threads(2)

# float64 on both sides; LU pivoting and summation orders differ, which
# costs a few ulp times the systems' condition numbers (~1e3-1e4).
RTOL = 1e-8
# Both packages refine their own float32 factors to the float64 solution of
# the same float64 systems (tests/test_torch_highprec.py).
HP_RTOL = 1e-9
FIELDS = ["stream", "current_density", "self_field"]
CURRENT_UNITS = "uA"


def _ring(dtype="float64"):
    device = sc.Device(
        "ring",
        layers=[sc.Layer("base", Lambda=0.8, z0=0)],
        films=[sc.Polygon("disk", layer="base", points=sc.geometry.circle(5, points=70))],
        holes=[sc.Polygon("hole", layer="base", points=sc.geometry.circle(1.5, points=36))],
        solve_dtype=dtype,
    )
    device.make_mesh(min_points=500)
    return device


def _strip(dtype="float64"):
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
        solve_dtype=dtype,
    )
    device.make_mesh(min_points=500)
    return device


# name: (function making the device, circulating currents, terminal currents, vortices
# (x, y), with a field from other films, low-memory path)
CASES = {
    "dense_hole_current": (_ring, {"hole": 1.5}, None, [], False, False),
    "two_vortices": (_ring, {"hole": 0.5}, None, [(0.5, 3.0), (-2.5, -2.5)], False, False),
    "field_from_other_films": (_ring, {"hole": 0.5}, None, [], True, False),
    "low_memory": (_ring, {"hole": 1.5}, None, [(0.5, 3.0)], True, True),
    "terminal_strip": (
        _strip, {"strip_hole": 0.3}, {"source": 2.0, "drain": -2.0}, [(1.2, 0.5)], True, False,
    ),
}


def _rel_err(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


def _drive(n, conv, with_others):
    rng = np.random.default_rng(7)
    applied = conv * (0.3 + 0.05 * rng.standard_normal(n))
    others = conv * 0.02 * rng.standard_normal(n) if with_others else None
    return applied, others


def _both_sides(ref_device, circulating, terminal_currents, vortices):
    """Each package's film info and systems for the device's one film."""
    name = next(iter(ref_device.films))
    device = st.device_from_reference(ref_device)
    terminals = {name: terminal_currents} if terminal_currents else {}
    ref_info = ref_utils.make_film_info(
        device=ref_device,
        vortices=[sc.Vortex(x=x, y=y, film=name) for x, y in vortices],
        circulating_currents=circulating,
        terminal_currents=terminals,
    )
    info = port_utils.make_film_info(
        device=device,
        vortices=[st.Vortex(x=x, y=y, film=name) for x, y in vortices],
        circulating_currents=circulating,
        terminal_currents=terminals,
        torch_device="cpu",
    )
    ref_systems = ref_sf.factorize_linear_systems(ref_device, ref_info)
    systems = port_sf.factorize_linear_systems(device, info)
    return name, (ref_device, ref_info, ref_systems), (device, info, systems)


def _call(module, name, side, applied, others, conv, **extra):
    device, info, (film_systems, hole_systems, terminal_systems) = side
    return module.solve_film(
        device=device,
        applied_field=applied,
        film_info=info[name],
        film_system=film_systems[name],
        hole_systems=hole_systems[name],
        field_conversion=conv,
        vortex_flux=float(sc.ureg("Phi_0 / mu_0").to(f"{CURRENT_UNITS} * um").magnitude),
        terminal_systems=terminal_systems.get(name),
        field_from_other_films=others,
        **extra,
    )


def _conv():
    return ref_utils.field_conversion_factor("mT", CURRENT_UNITS, "um").magnitude


@pytest.mark.parametrize("case", list(CASES))
def test_solve_film_matches_jax(monkeypatch, case):
    build, circulating, terminal_currents, vortices, with_others, lowmem = CASES[case]
    if lowmem:
        monkeypatch.setattr(ref_utils, "MAX_DENSE_KERNEL_SIZE", 10)
        monkeypatch.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    name, ref_side, port_side = _both_sides(build(), circulating, terminal_currents, vortices)
    assert port_side[1][name].dense_kernel == (not lowmem)
    conv = _conv()
    applied, others = _drive(len(ref_side[0].meshes[name].sites), conv, with_others)
    ref = _call(ref_sf, name, ref_side, applied, others, conv)
    # The port takes tensors as well as arrays.
    got = _call(
        port_sf, name, port_side, torch.as_tensor(applied),
        None if others is None else torch.as_tensor(others), conv,
    )
    assert isinstance(got, st.FilmSolution)
    for quantity in FIELDS:
        a, b = getattr(ref, quantity), getattr(got, quantity)
        assert b.shape == np.shape(a) and b.dtype == np.float64
        assert _rel_err(b, a) < RTOL, (quantity, _rel_err(b, a))
    np.testing.assert_array_equal(got.applied_field, ref.applied_field)
    if others is None:
        assert got.field_from_other_films is None
    else:
        np.testing.assert_allclose(got.field_from_other_films, others / conv, rtol=1e-15)


@pytest.mark.parametrize("build", [_ring, _strip], ids=["ring_two_vortices", "terminal_strip"])
def test_solve_film_hp_system_matches_jax(build):
    """``hp_system`` on float32 systems: both packages refine to the float64
    solution of the same float64 systems."""
    ref_device = build("float32")
    strip = "strip" in ref_device.films
    circulating = {"strip_hole": 0.3} if strip else {"hole": 1.0}
    terminal_currents = {"source": 2.0, "drain": -2.0} if strip else None
    vortices = [(1.2, 0.5)] if strip else [(0.5, 3.0), (-2.5, -2.5)]
    name, ref_side, port_side = _both_sides(ref_device, circulating, terminal_currents, vortices)
    ref_hp = ref_build_hp_system(
        ref_device, ref_side[1][name], ref_side[2][0][name],
        terminal_systems=ref_side[2][2].get(name),
    )
    hp = refine.build_hp_system(port_side[0], port_side[1][name], port_side[2][0][name])
    conv = _conv()
    applied, others = _drive(len(ref_device.meshes[name].sites), conv, True)
    ref = _call(ref_sf, name, ref_side, applied, others, conv, hp_system=ref_hp)
    got = _call(port_sf, name, port_side, applied, others, conv, hp_system=hp)
    for quantity in FIELDS:
        b = getattr(got, quantity)
        assert b.dtype == np.float64
        assert _rel_err(b, getattr(ref, quantity)) < HP_RTOL, quantity
    plain = _call(port_sf, name, port_side, applied, others, conv)
    assert plain.stream.dtype == np.float32
    # The float32 solve is float32-close to the float64 one, and no closer.
    assert 1e-9 < _rel_err(plain.stream, got.stream) < 1e-4


def _corrupted(lu_piv, tensor):
    lu, piv = lu_piv
    lu = lu.clone() if tensor else np.array(lu, copy=True)
    (lu.diagonal() if tensor else np.einsum("ii->i", lu))[...] *= 1.5
    return lu, piv


def test_solve_film_check_inversion_warns_as_jax(caplog):
    name, ref_side, port_side = _both_sides(_ring(), {"hole": 1.0}, None, [])
    conv = _conv()
    applied, _ = _drive(len(ref_side[0].meshes[name].sites), conv, False)
    for module, side in ((ref_sf, ref_side), (port_sf, port_side)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="solve"):
            _call(module, name, side, applied, None, conv, check_inversion=True)
        assert "Unable to solve" not in caplog.text, module.__name__
        system = side[2][0][name]
        good = system.lu_piv
        system.lu_piv = _corrupted(good, module is port_sf)
        try:
            with caplog.at_level(logging.WARNING, logger="solve"):
                _call(module, name, side, applied, None, conv)
            assert "Unable to solve" not in caplog.text  # not asked for
            with caplog.at_level(logging.WARNING, logger="solve"):
                _call(module, name, side, applied, None, conv, check_inversion=True)
        finally:
            system.lu_piv = good
        assert (
            "Unable to solve for stream function in 'disk', maximum error" in caplog.text
        ), module.__name__


def test_solve_film_is_exported_as_in_jax():
    port_solve = importlib.import_module("superscreen_tpu_torch.solver.solve")
    assert st.solver.solve_film is port_sf.solve_film is port_solve.solve_film
    assert "solve_film" in st.solver.__all__ and "solve_film" in port_sf.__all__


def test_dense_float32_self_fields_are_summed_in_float64():
    """The self-field ``Q (w g)`` of a dense float32 film cancels to a small
    part of its terms' sum: ``solve()`` and ``solve_film`` sum it in
    float64 (through ``residual_f64``), so both are within float32
    rounding of a float64 evaluation of the same float32 ``Q`` (a float32
    product over the six rounds' columns was 5e-5 to 1e-4 off at 20,000
    sites on the card, ~1e-6 here)."""
    device = st.device_from_reference(_ring("float32"))
    model = st.factorize_model(
        device=device, current_units=CURRENT_UNITS, circulating_currents={"hole": 1.0},
        torch_device="cpu",
    )
    solution = st.solve(
        model=model, applied_field=st.sources.ConstantField(0.3), iterations=0, torch_device="cpu"
    )[-1]
    fs = solution.film_solutions["disk"]
    info = port_utils.make_film_info(
        device=device, circulating_currents=model.circulating_currents, torch_device="cpu"
    )["disk"]
    conv = _conv()
    out = port_sf.solve_film(
        device=device, applied_field=fs.applied_field * conv, film_info=info,
        film_system=model.film_systems["disk"], hole_systems=model.hole_systems["disk"],
        field_conversion=conv,
        vortex_flux=float(sc.ureg("Phi_0 / mu_0").to(f"{CURRENT_UNITS} * um").magnitude),
    )
    for result in (fs, out):
        g = torch.as_tensor(result.stream, dtype=torch.float64)
        exact = info.kernel.double() @ (info.weights.double() * g) / conv
        assert result.self_field.dtype == np.float32
        err = float(np.abs(result.self_field - exact.numpy()).max() / exact.abs().max())
        assert err < 5e-7, err

"""The port's vortex energy landscape (``vortices``) against
``superscreen_tpu.vortices`` on a small disk, at float64 on the CPU
through ``device_from_reference``."""

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.solver import utils as ref_utils
from superscreen_tpu_torch.ops import linalg as port_linalg
from superscreen_tpu_torch.solver import utils as port_utils

torch.set_num_threads(2)

# float64 on both sides; LU pivoting and summation orders differ.
RTOL = 1e-8
# The matrix-free solves stop at a relative residual of 1e-6.
CG_RTOL = 1e-5
FIELD = 0.5


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def disks():
    """A coarse disk with a weak spot in Lambda, as in the JAX package's
    matrix-free landscape tests."""
    def weak_spot(x, y, depth=0.3):
        return 0.5 * (1 - depth * np.exp(-((x - 1.0) ** 2 + y**2) / 2.0))

    ref = sc.Device(
        "small_disk",
        layers=[sc.Layer("L", Lambda=sc.Parameter(weak_spot), z0=0)],
        films=[sc.Polygon("disk", layer="L", points=sc.geometry.circle(4.0, points=60))],
        length_units="um",
        solve_dtype="float64",
    )
    ref.make_mesh(min_points=400, smooth=5)
    return ref, st.device_from_reference(ref)


@pytest.fixture(scope="module")
def landscapes(disks):
    ref, port = disks
    kw = dict(field_units="mT", current_units="mA",
              vortices=None, circulating_currents=None)
    frozen = dict(x=-1.5, y=0.5, film="disk", nPhi0=1)
    ref_ls = sc.vortex_energy_landscape(
        ref, applied_field=sc.sources.ConstantField(FIELD), **{**kw, "vortices": [sc.Vortex(**frozen)]}
    )
    port_ls = st.vortex_energy_landscape(
        port, applied_field=st.sources.ConstantField(FIELD), torch_device="cpu",
        **{**kw, "vortices": [st.Vortex(**frozen)]},
    )
    return ref_ls, port_ls


def test_landscape_matches_jax(landscapes):
    ref, port = landscapes
    assert port.film == ref.film and port.units == ref.units
    assert np.array_equal(port.indices, ref.indices)
    assert np.array_equal(port.sites, ref.sites)
    assert _max_rel(port.self_energy, ref.self_energy) <= RTOL
    assert _max_rel(port.interaction, ref.interaction) <= RTOL
    for n in (1.0, -1.0, 2.0):
        assert _max_rel(port.total(n), ref.total(n)) <= RTOL
    E_ref, E_port = ref.energy_map(-1.0), port.energy_map(-1.0)
    assert _max_rel(E_port, E_ref) <= RTOL


def test_force_matches_jax(landscapes, disks):
    ref, port = landscapes
    pts = np.random.default_rng(0).uniform(-3.0, 3.0, (40, 2))
    pts = np.concatenate([pts, [[5.0, 5.0]]])  # one outside the film
    for n, units in ((1.0, "pN"), (-2.0, "fN")):
        F_ref = np.asarray(ref.force(pts, nPhi0=n, units=units))
        F_port = port.force(pts, nPhi0=n, units=units)
        assert np.array_equal(np.isnan(F_port), np.isnan(F_ref))
        ok = np.isfinite(F_ref)
        assert _max_rel(F_port[ok], F_ref[ok]) <= RTOL
    q = port.force(pts[:3], with_units=True)
    assert q.units == st.ureg("pN").units


def test_self_energy_is_the_vortex_solve(disks):
    """E_self at a site is half Phi_0 times the core stream of a solve with
    a vortex there: the same response column."""
    port = disks[1]
    ls = st.vortex_energy_landscape(port, torch_device="cpu")
    k = int(np.argmin(np.linalg.norm(ls.sites - [1.0, 0.5], axis=1)))
    x, y = ls.sites[k]
    sol = st.solve(port, vortices=[st.Vortex(x=float(x), y=float(y), film="disk")],
                   current_units="mA", torch_device="cpu")[-1]
    g_core = float(sol.film_solutions["disk"].stream[ls.indices[k]])
    expected = 0.5 * st.ureg(f"{g_core} Phi_0 * mA").to("eV").magnitude
    assert ls.self_energy[k] == pytest.approx(expected, rel=1e-10)
    np.testing.assert_allclose(ls.interaction, 0.0, atol=1e-12)


def _matrix_free(mp):
    mp.setattr(ref_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    mp.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    mp.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "cg")


def test_matrix_free_exact_diagonal_matches_dense(disks, landscapes):
    port = disks[1]
    dense = landscapes[1]
    with pytest.MonkeyPatch.context() as mp:
        _matrix_free(mp)
        model = st.factorize_model(device=port, current_units="mA", torch_device="cpu")
        assert model.film_systems["disk"].cg_op is not None
        model.set_vortices([st.Vortex(x=-1.5, y=0.5, film="disk")])
        mf = st.vortex_energy_landscape(
            model=model, applied_field=st.sources.ConstantField(FIELD), diag_method="exact",
            diag_options={"chunk": 128}, torch_device="cpu",
        )
    assert np.array_equal(mf.indices, dense.indices)
    assert _max_rel(mf.self_energy, dense.self_energy) <= CG_RTOL
    assert _max_rel(mf.interaction, dense.interaction) <= CG_RTOL


def test_matrix_free_probing_matches_jax(disks):
    ref, port = disks
    options = {"separation": 2.0, "repeats": 3, "seed": 7}
    with pytest.MonkeyPatch.context() as mp:
        _matrix_free(mp)
        ref_ls = sc.vortex_energy_landscape(ref, field_units="mT", diag_method="probing",
                                            diag_options=options)
        port_ls = st.vortex_energy_landscape(port, field_units="mT", diag_method="probing",
                                             diag_options=options, torch_device="cpu")
    assert _max_rel(port_ls.self_energy, ref_ls.self_energy) <= CG_RTOL


def test_probing_colors_match_jax(disks):
    from superscreen_tpu.ops import linalg as ref_linalg

    sites = disks[1].meshes["disk"].sites
    for separation in (0.5, 2.0):
        assert np.array_equal(
            port_linalg._probing_colors(sites, separation),
            ref_linalg._probing_colors(sites, separation),
        )


def test_landscape_contracts(disks):
    port = disks[1]
    with pytest.raises(ValueError, match="exactly one"):
        st.vortex_energy_landscape(torch_device="cpu")
    with pytest.raises(KeyError, match="nope"):
        st.vortex_energy_landscape(port, film="nope", torch_device="cpu")
    model = st.factorize_model(device=port, current_units="mA", torch_device="cpu")
    with pytest.raises(ValueError, match="baked into the model"):
        st.vortex_energy_landscape(model=model, vortices=[], torch_device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _matrix_free(mp)
        mf = st.factorize_model(device=port, current_units="mA", torch_device="cpu")
    with pytest.raises(ValueError, match="Unknown diagonal method"):
        st.vortex_energy_landscape(model=mf, diag_method="guess", torch_device="cpu")

"""The port's field sources against ``superscreen_tpu.sources`` on the same
seeded NumPy inputs, at float64 on the CPU."""

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st

torch.set_num_threads(2)

# The same float64 sums in another order (relative to max|reference|).
TOL = 1e-12


def _sheet(n=180, seed=3):
    rng = np.random.default_rng(seed)
    positions = rng.uniform(-3, 3, (n, 2))
    densities = rng.standard_normal((n, 2))
    areas = rng.uniform(0.05, 0.2, n)
    return positions, densities, areas


def _targets(kind, m=57, seed=5):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-4, 4, (2, m))
    if kind == "uniform":
        return x, y, 0.75
    if kind == "uniform_vector":
        return x, y, np.full(m, 0.75)
    return x, y, rng.uniform(0.2, 2.0, m)


def _assert_close(got, expected):
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=TOL * np.abs(expected).max())


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("heights", ["uniform", "uniform_vector", "mixed"])
@pytest.mark.parametrize("with_areas", [True, False])
def test_biot_savart_2d_matches_reference(vector, heights, with_areas):
    positions, densities, areas = _sheet()
    x, y, z = _targets(heights)
    kwargs = dict(
        positions=positions, current_densities=densities, z0=0.25,
        areas=areas if with_areas else None, length_units="um", current_units="mA",
        vector=vector,
    )
    expected = sc.sources.biot_savart_2d(x, y, z, **kwargs)
    got = st.sources.biot_savart_2d(x, y, z, torch_device="cpu", **kwargs)
    assert got.dtype == np.float64
    _assert_close(got, expected)


def test_biot_savart_2d_scalar_point_and_units():
    positions, densities, areas = _sheet(60)
    kwargs = dict(positions=positions, current_densities=densities, areas=areas, z0=-0.5,
                  length_units="nm", current_units="uA")
    for vector in (False, True):
        expected = sc.sources.biot_savart_2d(0.3, -0.2, 1.0, vector=vector, **kwargs)
        got = st.sources.biot_savart_2d(0.3, -0.2, 1.0, vector=vector, torch_device="cpu", **kwargs)
        _assert_close(got, expected)


def test_biot_savart_2d_in_plane_point_on_a_site():
    """dz = 0 with an evaluation point on a sheet position: the r = 0 pair
    contributes zero on both sides."""
    positions, densities, areas = _sheet(80)
    x = np.concatenate([positions[:5, 0], [3.5, -3.7]])
    y = np.concatenate([positions[:5, 1], [0.1, 0.2]])
    kwargs = dict(positions=positions, current_densities=densities, areas=areas, z0=0.5,
                  vector=False)
    expected = sc.sources.biot_savart_2d(x, y, 0.5, **kwargs)
    got = st.sources.biot_savart_2d(x, y, 0.5, torch_device="cpu", **kwargs)
    assert np.isfinite(got).all()
    _assert_close(got, expected)


def test_biot_savart_2d_float32_densities_sum_in_float32():
    positions, densities, areas = _sheet(90)
    x, y, z = _targets("uniform")
    kwargs = dict(positions=positions, areas=areas, z0=0.0, vector=False, torch_device="cpu")
    exact = st.sources.biot_savart_2d(x, y, z, current_densities=densities, **kwargs)
    single = st.sources.biot_savart_2d(
        x, y, z, current_densities=densities.astype(np.float32), **kwargs
    )
    assert single.dtype == np.float32
    np.testing.assert_allclose(single, exact, rtol=0, atol=1e-5 * np.abs(exact).max())


def test_biot_savart_2d_defaults_to_the_card():
    positions, densities, areas = _sheet(10)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.sources.biot_savart_2d(0.0, 0.0, 1.0, positions=positions,
                                  current_densities=densities, areas=areas)


def test_sheet_current_field_matches_reference():
    positions, densities, _ = _sheet(120)
    x, y, _ = _targets("uniform")
    kwargs = dict(sheet_positions=positions, current_densities=densities, z0=1.5,
                  length_units="um", current_units="uA")
    ref = sc.sources.SheetCurrentField(**kwargs)
    port = st.sources.SheetCurrentField(torch_device="cpu", **kwargs)
    assert isinstance(port, st.Parameter)
    _assert_close(np.asarray(port(x, y, 0.0)), np.asarray(ref(x, y, 0.0)))
    z = np.linspace(-1, 1, len(x))
    _assert_close(np.asarray(port(x, y, z)), np.asarray(ref(x, y, z)))


@pytest.mark.parametrize("component", [None, "x", "y", "z"])
@pytest.mark.parametrize("single_moment", [False, True])
def test_dipole_field_matches_reference(component, single_moment):
    rng = np.random.default_rng(17)
    dipoles = rng.uniform(-2, 2, (6, 3))
    moments = np.array([0.0, 0.5, 1.0]) if single_moment else rng.standard_normal((6, 3))
    x, y, z = rng.uniform(-3, 3, (3, 40))
    kwargs = dict(dipole_positions=dipoles, dipole_moments=moments, component=component)
    ref = sc.sources.DipoleField(**kwargs)(x, y, z + 5)
    port = st.sources.DipoleField(**kwargs)(x, y, z + 5)
    _assert_close(np.asarray(port), np.asarray(ref))
    coords = np.stack([x, y, z + 5], axis=1) * 1e-6
    _assert_close(
        st.sources.dipole_field(coords, r0=(0, 0, 1e-6), moment=(1e-18, 0, 2e-18)),
        sc.sources.dipole_field(coords, r0=(0, 0, 1e-6), moment=(1e-18, 0, 2e-18)),
    )


def test_dipole_field_rejects_bad_input():
    with pytest.raises(ValueError, match="Component"):
        st.sources.DipoleField(dipole_positions=(0, 0, 0), dipole_moments=(0, 0, 1), component="w")
    with pytest.raises(ValueError, match="number of dipole moments"):
        st.sources.dipole_distribution(
            0.0, 0.0, 1.0, dipole_positions=np.zeros((3, 3)), dipole_moments=np.ones((2, 3))
        )


@pytest.mark.parametrize("vector", [False, True])
def test_monopole_field_matches_reference(vector):
    rng = np.random.default_rng(23)
    x, y, z = rng.uniform(-3, 3, (3, 50))
    kwargs = dict(r0=(0.5, -0.25, -1.0), nPhi0=2, vector=vector)
    ref = sc.sources.MonopoleField(**kwargs)(x, y, z + 4)
    port = st.sources.VortexField(**kwargs)(x, y, z + 4)
    _assert_close(np.asarray(port), np.asarray(ref))


def test_pearl_vortex_field_matches_reference():
    xs = np.linspace(-6, 6, 65)
    ys = np.linspace(-5, 5, 49)
    rng = np.random.default_rng(29)
    x, y = rng.uniform(-3, 3, (2, 30))
    kwargs = dict(r0=(0.5, 0.25, 0.0), Lambda=0.4, nPhi0=1, xs=xs, ys=ys)
    ref = sc.sources.PearlVortexField(**kwargs)(x, y, 0.8)
    port = st.sources.PearlVortexField(**kwargs)(x, y, 0.8)
    _assert_close(np.asarray(port), np.asarray(ref))
    with pytest.raises(ValueError, match="must be equal"):
        st.sources.pearl_vortex(x, y, np.linspace(0, 1, 30), xs=xs, ys=ys)
    with pytest.raises(ValueError, match="convex hull"):
        st.sources.pearl_vortex(x + 10, y, 0.8, xs=xs, ys=ys)

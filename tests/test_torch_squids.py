"""The port's SQUID susceptometer layouts (``squids/``, host geometry)
against ``superscreen_tpu.squids``: every polygon point for point, and the
pickup-loop / field-coil mutual inductance of a coarse Huber layout and a
coarse parametric susceptometer on the same meshes, on the CPU."""

import numpy as np
import pytest
import torch

import superscreen_tpu.squids as ref_squids
import superscreen_tpu_torch as st
import superscreen_tpu_torch.squids as squids
from superscreen_tpu_torch.solver import utils as port_utils

torch.set_num_threads(2)

# The layouts are the same arithmetic on the same digitized coordinates.
POINT_TOL = 1e-12
# Mutual inductances of the two packages at float64 on one mesh.  The
# streams agree to ~1e-9, but the JAX package's Solution interpolates the
# fluxoid contour at float32 whatever the solve dtype, which leaves ~3e-8.
MUTUAL_RTOL = 2e-7


def _assert_same_device(device, ref):
    assert device.name == ref.name and device.length_units == ref.length_units
    for group in ("films", "holes", "abstract_regions"):
        ours, theirs = getattr(device, group), getattr(ref, group)
        assert list(ours) == list(theirs), group
        for name, polygon in theirs.items():
            assert ours[name].layer == polygon.layer
            assert ours[name].points.shape == np.asarray(polygon.points).shape
            assert np.abs(ours[name].points - np.asarray(polygon.points)).max() <= POINT_TOL
    assert list(device.layers) == list(ref.layers)
    for name, layer in ref.layers.items():
        ours = device.layers[name]
        assert (ours.Lambda, ours.z0, ours.thickness, ours.london_lambda) == (
            layer.Lambda, layer.z0, layer.thickness, layer.london_lambda
        )
    assert list(device.terminals) == list(ref.terminals)
    for film, terminals in ref.terminals.items():
        assert [t.name for t in device.terminals[film]] == [t.name for t in terminals]
        for ours, theirs in zip(device.terminals[film], terminals):
            assert np.abs(ours.points - np.asarray(theirs.points)).max() <= POINT_TOL


@pytest.mark.parametrize("with_terminals", [True, False])
@pytest.mark.parametrize("layout", list(ref_squids.SQUID_LAYOUTS))
def test_layout_matches_jax_point_for_point(layout, with_terminals):
    assert list(squids.SQUID_LAYOUTS) == list(ref_squids.SQUID_LAYOUTS)
    _assert_same_device(
        squids.SQUID_LAYOUTS[layout](with_terminals=with_terminals),
        ref_squids.SQUID_LAYOUTS[layout](with_terminals=with_terminals),
    )


@pytest.mark.parametrize("preset", list(ref_squids.SQUID_PRESETS))
def test_parametric_susceptometer_matches_jax(preset):
    assert squids.SQUID_PRESETS[preset] == squids.SusceptometerGeometry(
        **vars(ref_squids.SQUID_PRESETS[preset])
    )
    _assert_same_device(squids.make_squid(preset), ref_squids.make_squid(preset))
    _assert_same_device(
        squids.make_squid(preset, with_terminals=False),
        ref_squids.make_squid(preset, with_terminals=False),
    )


def test_meshing_targets_and_bundled_data_match_jax():
    assert squids.MAX_EDGE_LENGTHS == ref_squids.MAX_EDGE_LENGTHS
    assert squids.mutuals.MAX_EDGE_LENGTHS["huber"] == 0.4
    for ours, theirs in zip(
        squids.hypres_squid_layers() + squids.ibm_squid_layers(),
        ref_squids.hypres_squid_layers() + ref_squids.ibm_squid_layers(),
    ):
        assert (ours.name, ours.london_lambda, ours.thickness, ours.z0) == (
            theirs.name, theirs.london_lambda, theirs.thickness, theirs.z0
        )


def test_loop_with_leads_matches_jax():
    args = dict(radius=1.6, lead_width=0.5, lead_length=5.0, angle=30.0, arc_points=41)
    ours = squids.loop_with_leads(**args)
    theirs = ref_squids.loop_with_leads(**args)
    assert ours.shape == theirs.shape and ours.shape[1] == 2
    assert np.abs(ours - theirs).max() <= POINT_TOL


@pytest.fixture(scope="module")
def coarse_huber():
    """The closed Huber layout, meshed coarsely by the JAX package; the port
    solves the same mesh.  float64 on both sides.  (With terminals the
    field coil keeps its 14,000 boundary-driven sites at any edge length:
    the terminal route is tested on the parametric susceptometer.)"""
    ref = ref_squids.SQUID_LAYOUTS["huber"](with_terminals=False)
    ref.solve_dtype = "float64"
    ref.make_mesh(max_edge_length=2.0, smooth=10)
    return ref, st.device_from_reference(ref)


@pytest.fixture(scope="module")
def coarse_squids():
    """The small parametric susceptometer with and without terminals."""
    out = {}
    for with_terminals in (True, False):
        ref = ref_squids.make_squid("small", with_terminals=with_terminals)
        ref.solve_dtype = "float64"
        ref.make_mesh(min_points=400)
        out[with_terminals] = (ref, st.device_from_reference(ref))
    return out


def test_coarse_devices_are_small(coarse_huber, coarse_squids):
    sizes = {name: len(mesh.sites) for name, mesh in coarse_huber[1].meshes.items()}
    assert set(sizes) == {"fc", "fc_shield", "pl", "pl_shield"}
    assert max(sizes.values()) < 3000 and min(sizes.values()) > 100, sizes
    for _, device in coarse_squids.values():
        assert max(len(mesh.sites) for mesh in device.meshes.values()) < 3000


def test_pickup_loop_mutual_on_coarse_huber_matches_jax(coarse_huber):
    ref, device = coarse_huber
    expected = ref_squids.pickup_loop_mutual(ref, iterations=2)
    mutual = squids.pickup_loop_mutual(device, iterations=2, torch_device="cpu")
    assert str(mutual.units) == str(expected.units)
    np.testing.assert_allclose(mutual.magnitude, expected.magnitude, rtol=MUTUAL_RTOL)
    # About 2 pH, as the layout's published figure.
    assert 1.0 < mutual.to("pH").magnitude < 3.0


@pytest.mark.parametrize("with_terminals", [True, False])
def test_susceptometer_mutuals_match_jax(coarse_squids, with_terminals):
    ref, device = coarse_squids[with_terminals]
    assert bool(device.terminals) == with_terminals
    expected = ref_squids.pickup_loop_mutual(ref, iterations=2)
    mutual = squids.pickup_loop_mutual(device, iterations=2, torch_device="cpu")
    np.testing.assert_allclose(mutual.magnitude, expected.magnitude, rtol=MUTUAL_RTOL)
    # The solve() route of squid_mutual_inductance.
    expected = ref_squids.squid_mutual_inductance(ref, iterations=2)
    mutual = squids.squid_mutual_inductance(device, iterations=2, torch_device="cpu")
    np.testing.assert_allclose(mutual.magnitude, expected.magnitude, rtol=MUTUAL_RTOL)


@pytest.mark.parametrize("with_terminals", [True, False])
def test_pickup_loop_mutual_precisions_agree(coarse_squids, with_terminals):
    _, device64 = coarse_squids[with_terminals]
    device = device64.copy()
    device.solve_dtype = "float32"
    kwargs = dict(iterations=2, units="pH", torch_device="cpu")
    exact = squids.pickup_loop_mutual(device64, **kwargs).magnitude
    plain = squids.pickup_loop_mutual(device, **kwargs).magnitude
    precise = squids.pickup_loop_mutual(device, high_precision=True, **kwargs).magnitude
    assert abs(plain - exact) <= 1e-4 * abs(exact)
    # The float64 refinement reaches the float64 systems' answer.
    assert abs(precise - exact) <= 1e-9 * abs(exact)
    if with_terminals:
        polished = squids.pickup_loop_mutual(device, final_refine=2, **kwargs).magnitude
        assert abs(polished - exact) <= 1e-4 * abs(exact)


def test_pickup_loop_mutual_defaults_to_the_card(coarse_squids):
    _, device = coarse_squids[True]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        squids.pickup_loop_mutual(device, iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        squids.squid_mutual_inductance(device, iterations=1)


def test_compute_mutuals_meshes_and_solves_a_layout(monkeypatch):
    # Coarse, and low-memory for nothing: the layout's films stay dense.
    monkeypatch.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 25000)
    out = squids.compute_mutuals(
        ["ibm-small"], iterations=1, smooth=0, with_terminals=False, max_edge_scale=8.0,
        torch_device="cpu",
    )
    assert list(out) == ["ibm-small"]
    assert out["ibm-small"].units == st.ureg("Phi_0 / A").units
    assert np.isfinite(out["ibm-small"].magnitude) and out["ibm-small"].magnitude > 0

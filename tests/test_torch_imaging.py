"""The port's current imaging (``imaging``) against
``superscreen_tpu.imaging`` on seeded grids, at float64 on the CPU."""

import numpy as np
import pytest
import torch

from superscreen_tpu import imaging as ref_imaging
from superscreen_tpu_torch import imaging as port_imaging

torch.set_num_threads(2)

# The same float64 transforms (pocketfft against the JAX package's XLA
# FFT) and the same window and gain.
RTOL = 1e-12


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _maps(seed, shape=(48, 64)):
    """A smooth stream (two Gaussians) plus seeded noise, in SI units."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    y, x = np.meshgrid(np.arange(ny) * 0.2e-6, np.arange(nx) * 0.25e-6, indexing="ij")
    g = 1e-3 * np.exp(-((x - 7e-6) ** 2 + (y - 4e-6) ** 2) / (2 * (1.5e-6) ** 2))
    g -= 4e-4 * np.exp(-((x - 11e-6) ** 2 + (y - 6e-6) ** 2) / (2 * (1e-6) ** 2))
    return g + 1e-6 * rng.standard_normal(shape), 0.25e-6, 0.2e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_to_bz_and_back(seed):
    g, dx, dy = _maps(seed)
    z = 0.6e-6
    ref_bz = np.asarray(ref_imaging.stream_to_bz(g, dx, dy, z))
    bz = port_imaging.stream_to_bz(g, dx, dy, z, torch_device="cpu")
    assert isinstance(bz, torch.Tensor) and bz.dtype == torch.float64
    assert _max_rel(bz.numpy(), ref_bz) <= RTOL
    for kw in ({}, {"k_cutoff": 4e6}, {"max_amplification": 20.0}):
        ref_g = np.asarray(ref_imaging.bz_to_stream(ref_bz, dx, dy, z, **kw))
        out = port_imaging.bz_to_stream(ref_bz, dx, dy, z, torch_device="cpu", **kw)
        assert _max_rel(out.numpy(), ref_g) <= RTOL, kw


@pytest.mark.parametrize("seed", [2, 3])
def test_current_densities(seed):
    g, dx, dy = _maps(seed, shape=(40, 40))
    z = 0.5e-6
    ref = [np.asarray(a) for a in ref_imaging.stream_to_current_density(g, dx, dy)]
    # A tensor argument computes on its own device.
    out = port_imaging.stream_to_current_density(torch.as_tensor(g), dx, dy)
    for a, b in zip(ref, out):
        assert _max_rel(b.numpy(), a) <= RTOL
    bz = np.asarray(ref_imaging.stream_to_bz(g, dx, dy, z))
    ref = [np.asarray(a) for a in ref_imaging.bz_to_current_density(bz, dx, dy, z, k_cutoff=5e6)]
    out = port_imaging.bz_to_current_density(bz, dx, dy, z, k_cutoff=5e6, torch_device="cpu")
    for a, b in zip(ref, out):
        assert _max_rel(b.numpy(), a) <= RTOL


@pytest.mark.parametrize(
    "units", [("mT", "um", "uA"), ("Oe", "nm", "mA")], ids=["mT_um_uA", "Oe_nm_mA"]
)
def test_invert_field_map(units):
    field_units, length_units, current_units = units
    rng = np.random.default_rng(4)
    bz = rng.standard_normal((32, 36)) * 0.1
    kw = dict(field_units=field_units, length_units=length_units, current_units=current_units)
    scale = 1e3 if length_units == "nm" else 1.0
    for extra in ({}, {"k_cutoff": 3.0 / scale}):
        ref = ref_imaging.invert_field_map(bz, 0.25 * scale, 0.2 * scale, 0.5 * scale, **kw, **extra)
        out = port_imaging.invert_field_map(
            bz, 0.25 * scale, 0.2 * scale, 0.5 * scale, torch_device="cpu", **kw, **extra
        )
        for a, b in zip(ref, out):
            assert isinstance(b, np.ndarray)
            assert _max_rel(b, a) <= RTOL


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_imaging.stream_to_bz(np.zeros((4, 4)), 1.0, 1.0, 1.0)

"""The port's scanning SQUID microscopy (``squids.scanning``) against
``superscreen_tpu.squids.scanning`` on a shrunk copy of the reference's
scanning configuration (a mini susceptometer over a disk), at float64 on
the CPU through ``device_from_reference``; the differentiable scan
(``build_scan_forward``) against the JAX one and against the port's
``susceptibility_scan``; and the float32 scan's distance from float64 in
both packages on the same mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu.squids import scanning as ref_scanning
from superscreen_tpu_torch.squids import scanning as port_scanning

torch.set_num_threads(2)

# float64 on both sides; the sweeps' LU pivoting and summation orders
# differ by a few ulp times the systems' condition numbers.
RTOL = 1e-8
B = 4
HEIGHT = 1.0
I_FC = "1 mA"


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _squid():
    """The reference's mini susceptometer, meshed coarsely."""
    return sc.Device(
        "mini_squid",
        layers=[sc.Layer("sq", Lambda=0.3, z0=0)],
        films=[sc.Polygon("fc_ring", layer="sq", points=sc.geometry.circle(1.5, points=40))],
        holes=[sc.Polygon("fc_hole", layer="sq", points=sc.geometry.circle(0.9, points=30))],
        abstract_regions=[sc.Polygon("pl", layer="sq", points=sc.geometry.circle(0.4, points=24))],
        length_units="um",
        solve_dtype="float64",
    )


def _sample():
    return sc.Device(
        "sample",
        layers=[sc.Layer("s", Lambda=0.1, z0=0)],
        films=[sc.Polygon("disk", layer="s", points=sc.geometry.circle(6.0, points=60))],
        length_units="um",
        solve_dtype="float64",
    )


@pytest.fixture(scope="module")
def setup():
    ref_squid, ref_sample = _squid(), _sample()
    ref_squid.make_mesh(min_points=300, smooth=5)
    ref_sample.make_mesh(min_points=500, smooth=5)
    squid, sample = (st.device_from_reference(d) for d in (ref_squid, ref_sample))
    drive = dict(circulating_currents={"fc_hole": I_FC}, field_units="mT", current_units="mA")
    ref_sol = sc.solve(ref_squid, progress_bar=False, **drive)[-1]
    # The JAX Solution copies its device without the solve dtype, and the
    # back-action and screening rounds factorize that copy (ROADMAP 3.7).
    ref_sol.device.solve_dtype = ref_squid.solve_dtype
    port_sol = st.solve(squid, torch_device="cpu", **drive)[-1]
    positions = np.column_stack([np.linspace(-8.0, 8.0, B), np.zeros(B)])
    return dict(
        ref=(ref_squid, ref_sample, ref_sol), port=(squid, sample, port_sol), positions=positions
    )


@pytest.mark.parametrize("per_position", [False, True], ids=["scalar_height", "per_position"])
def test_applied_field_maps(setup, per_position):
    ref_squid, ref_sample, ref_sol = setup["ref"]
    squid, sample, port_sol = setup["port"]
    height = HEIGHT + 0.25 * np.arange(B) if per_position else HEIGHT
    kw = dict(squid_height=height, current_units="uA")
    ref = ref_scanning.applied_field_maps(ref_sample, ref_sol, setup["positions"], **kw)
    out = port_scanning.applied_field_maps(
        sample, port_sol, setup["positions"], torch_device="cpu", **kw
    )
    for name, a in ref.items():
        b = out[name]
        assert isinstance(b, torch.Tensor) and tuple(b.shape) == (B, len(sample.meshes[name].sites))
        assert _max_rel(b.numpy(), a) <= RTOL, name


@pytest.mark.parametrize(
    "back_action,batch_size", [(0, None), (0, 3), (1, None), (1, 3)],
    ids=["first_order", "first_order_batched", "back_action", "back_action_batched"],
)
def test_susceptibility_scan(setup, back_action, batch_size):
    ref_squid, ref_sample, ref_sol = setup["ref"]
    squid, sample, port_sol = setup["port"]
    kw = dict(
        positions=setup["positions"], squid_height=HEIGHT, pickup_loop="pl", I_fc=I_FC,
        back_action=back_action, batch_size=batch_size,
    )
    ref = ref_scanning.susceptibility_scan(ref_sample, squid_solution=ref_sol, **kw)
    out = port_scanning.susceptibility_scan(sample, squid_solution=port_sol, torch_device="cpu", **kw)
    assert out.shape == (B,) and np.all(np.isfinite(out))
    assert _max_rel(out, ref) <= RTOL


@pytest.mark.parametrize("back_action", [0, 1], ids=["first_order", "back_action"])
def test_sharded_susceptibility_scan_matches_unsharded(setup, back_action):
    """The scan's sweeps split over two data rows give the unsharded scan."""
    from superscreen_tpu_torch import parallel

    squid, sample, port_sol = setup["port"]
    kw = dict(
        positions=setup["positions"], squid_height=HEIGHT, pickup_loop="pl", I_fc=I_FC,
        back_action=back_action, torch_device="cpu",
    )
    ref = port_scanning.susceptibility_scan(sample, squid_solution=port_sol, **kw)
    mesh = parallel.make_mesh(n_data=2, devices=["cpu"] * 2)
    out = port_scanning.susceptibility_scan(
        sample, squid_solution=port_sol, sharding=parallel.batch_sharding(mesh), **kw
    )
    assert _max_rel(out, ref) <= 1e-10


def test_susceptibility_scan_with_a_model_per_position_heights_and_units(setup):
    ref_squid, ref_sample, ref_sol = setup["ref"]
    squid, sample, port_sol = setup["port"]
    heights = HEIGHT + 0.5 * np.arange(B)
    kw = dict(
        positions=setup["positions"], squid_height=heights, pickup_loop="pl", I_fc=1e-3,
        with_units=True, units="Phi_0 / mA",
    )
    ref = ref_scanning.susceptibility_scan(
        sample_model=sc.factorize_model(device=ref_sample, current_units="mA"),
        squid_solution=ref_sol, **kw,
    )
    model = st.factorize_model(device=sample, current_units="mA", torch_device="cpu")
    out = port_scanning.susceptibility_scan(
        sample_model=model, squid_solution=port_sol, torch_device="cpu", **kw
    )
    assert str(out.units) == str(ref.units)
    assert _max_rel(out.magnitude, ref.magnitude) <= RTOL


@pytest.fixture(scope="module")
def vortex_samples(setup):
    """The sample holding a Pearl vortex in a weak field, solved by each
    package."""
    ref_squid, ref_sample, ref_sol = setup["ref"]
    squid, sample, port_sol = setup["port"]
    kw = dict(field_units="mT", current_units="uA")
    ref = sc.solve(
        ref_sample, applied_field=sc.sources.ConstantField(0.05),
        vortices=[sc.Vortex(x=1.0, y=0.5, film="disk")], progress_bar=False, **kw,
    )[-1]
    ref.device.solve_dtype = ref_sample.solve_dtype
    out = st.solve(
        sample, applied_field=st.sources.ConstantField(0.05),
        vortices=[st.Vortex(x=1.0, y=0.5, film="disk")], torch_device="cpu", **kw,
    )[-1]
    return ref, out


@pytest.mark.parametrize("screening", [False, True], ids=["bare_loop", "screening"])
def test_magnetometry_scan(setup, vortex_samples, screening):
    ref_squid, ref_sample, ref_sol = setup["ref"]
    squid, sample, port_sol = setup["port"]
    ref_solution, port_solution = vortex_samples
    kw = dict(positions=setup["positions"], squid_height=HEIGHT, pickup_loop="pl",
              screening=screening, batch_size=3)
    ref = ref_scanning.magnetometry_scan(ref_solution, squid_device=ref_squid, **kw)
    out = port_scanning.magnetometry_scan(
        port_solution, squid_device=squid, torch_device="cpu", **kw
    )
    assert out.shape == (B,)
    assert _max_rel(out, ref) <= RTOL


def test_magnetometry_scan_with_an_explicit_contour(setup, vortex_samples):
    ref_solution, port_solution = vortex_samples
    contour = sc.geometry.circle(0.5, points=20)
    kw = dict(positions=setup["positions"], squid_height=HEIGHT + 0.5 * np.arange(B),
              pickup_loop=contour)
    ref = ref_scanning.magnetometry_scan(ref_solution, **kw)
    out = port_scanning.magnetometry_scan(port_solution, torch_device="cpu", **kw)
    assert _max_rel(out, ref) <= RTOL


def test_scanning_contracts(setup):
    squid, sample, port_sol = setup["port"]
    kw = dict(positions=setup["positions"], squid_height=HEIGHT, pickup_loop="pl", I_fc=I_FC)
    with pytest.raises(ValueError, match="squid_height"):
        port_scanning.build_scan_forward(sample, port_sol, setup["positions"],
                                         squid_height=np.ones(B + 1), pickup_loop="pl", I_fc=I_FC,
                                         torch_device="cpu")
    with pytest.raises(KeyError, match="nope"):
        port_scanning.build_scan_forward(sample, port_sol, setup["positions"], squid_height=HEIGHT,
                                         pickup_loop="nope", I_fc=I_FC, torch_device="cpu")
    with pytest.raises(TypeError, match="NamedSharding"):
        port_scanning.susceptibility_scan(sample, squid_solution=port_sol, sharding=object(),
                                          torch_device="cpu", **kw)
    with pytest.raises(TypeError, match="NamedSharding"):
        port_scanning.magnetometry_scan(None, positions=setup["positions"], squid_height=HEIGHT,
                                        pickup_loop=[(0, 0), (1, 0), (0, 1)], sharding=object(),
                                        torch_device="cpu")
    with pytest.raises(ValueError, match="squid_height"):
        port_scanning.applied_field_maps(sample, port_sol, setup["positions"],
                                         squid_height=np.ones(B + 1), current_units="uA",
                                         torch_device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        port_scanning.susceptibility_scan(squid_solution=port_sol, torch_device="cpu", **kw)
    with pytest.raises(KeyError, match="nope"):
        port_scanning.susceptibility_scan(sample, squid_solution=port_sol, torch_device="cpu",
                                          **{**kw, "pickup_loop": "nope"})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_scanning.applied_field_maps(sample, port_sol, setup["positions"],
                                             squid_height=HEIGHT, current_units="uA")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_scanning.build_scan_forward(sample, port_sol, setup["positions"],
                                             squid_height=HEIGHT, pickup_loop="pl", I_fc=I_FC)


@pytest.mark.parametrize("per_position", [False, True], ids=["scalar_height", "per_position"])
def test_build_scan_forward_matches_reference_and_scan(setup, per_position):
    """The value against the JAX model's and the port's first-order
    ``susceptibility_scan`` (1e-10), and the gradient of a map misfit with
    respect to the sample's Lambda against ``jax.grad`` (1e-8)."""
    ref_squid, ref_sample, ref_sol = setup["ref"]
    squid, sample, port_sol = setup["port"]
    height = HEIGHT + 0.25 * np.arange(B) if per_position else HEIGHT
    kw = dict(squid_height=height, pickup_loop="pl", I_fc=I_FC)
    ref_model, ref_scan = ref_scanning.build_scan_forward(ref_sample, ref_sol, setup["positions"], **kw)
    model, scan = port_scanning.build_scan_forward(
        sample, port_sol, setup["positions"], torch_device="cpu", **kw
    )
    ref_params = ref_model.default_params()
    params = st.adjoint_params_from_reference(ref_params, torch.float64, "cpu")
    ref_map = np.asarray(jax.jit(ref_scan)(ref_params))
    out = scan(params)
    assert out.shape == (B,)
    assert _max_rel(out.detach().numpy(), ref_map) <= 1e-10
    first_order = port_scanning.susceptibility_scan(
        sample, squid_solution=port_sol, positions=setup["positions"], torch_device="cpu", **kw
    )
    assert _max_rel(out.detach().numpy(), first_order) <= 1e-10
    target = 1.1 * ref_map

    def ref_loss(lam):
        chi = ref_scan({**ref_params, "Lambda": {"disk": lam}})
        return jnp.mean((chi - target) ** 2)

    lam = params["Lambda"]["disk"].clone().requires_grad_()
    chi = scan({**params, "Lambda": {"disk": lam}})
    (grad,) = torch.autograd.grad(torch.mean((chi - torch.as_tensor(target)) ** 2), lam)
    ref_grad = jax.grad(ref_loss)(jnp.asarray(ref_params["Lambda"]["disk"]))
    assert _max_rel(grad.numpy(), np.asarray(ref_grad)) <= 1e-8


def test_float32_scan_is_no_further_from_float64_than_the_reference(setup):
    """The first-order scan in float32 and in float64 through both packages
    on the same meshes: the port's float32 map is no further from its
    float64 map than the JAX package's is from its own."""
    ref_squid, ref_sample, ref_sol = setup["ref"]
    kw = dict(positions=setup["positions"], squid_height=HEIGHT, pickup_loop="pl", I_fc=I_FC)
    drive = dict(circulating_currents={"fc_hole": I_FC}, field_units="mT", current_units="mA")
    maps = {}
    for dtype in ("float64", "float32"):
        ref_squid_d, ref_sample_d = ref_squid.copy(), ref_sample.copy()
        ref_squid_d.solve_dtype = ref_sample_d.solve_dtype = dtype
        ref_sol_d = sc.solve(ref_squid_d, progress_bar=False, **drive)[-1]
        maps["ref", dtype] = ref_scanning.susceptibility_scan(ref_sample_d, squid_solution=ref_sol_d, **kw)
        squid, sample = (st.device_from_reference(d) for d in (ref_squid_d, ref_sample_d))
        port_sol_d = st.solve(squid, torch_device="cpu", **drive)[-1]
        maps["port", dtype] = port_scanning.susceptibility_scan(
            sample, squid_solution=port_sol_d, torch_device="cpu", **kw
        )
    ref_gap = _max_rel(maps["ref", "float32"], maps["ref", "float64"])
    port_gap = _max_rel(maps["port", "float32"], maps["port", "float64"])
    print(f"float32 against float64: port {port_gap:.3e}, reference {ref_gap:.3e}")
    assert _max_rel(maps["port", "float64"], maps["ref", "float64"]) <= RTOL
    assert port_gap <= 1e-5  # the reference's bar on the card (BENCH_DETAIL_r05.json)
    assert port_gap <= ref_gap, (port_gap, ref_gap)

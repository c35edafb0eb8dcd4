"""The port's differentiable solve (``superscreen_tpu_torch.adjoint``)
against ``superscreen_tpu.adjoint`` on the same meshes
(``device_from_reference``) and parameters
(``adjoint_params_from_reference``), float64 on the CPU: every case of
``tests/test_adjoint.py``.  Forward fields agree within 1e-10 and
``torch.autograd`` gradients with ``jax.grad`` of the same loss within
1e-8; the port also meets the JAX tests' finite-difference bars.  Then
``torch.autograd.gradcheck`` on the port's autograd Functions at tiny
sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu import adjoint as ref_adjoint
from superscreen_tpu_torch import adjoint
from superscreen_tpu_torch.ops import autograd, kernels

torch.set_num_threads(2)

FORWARD_RTOL = 1e-10
GRAD_RTOL = 1e-8
F64 = torch.float64


def _rel_err(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _models(ref_device, **kwargs):
    """The JAX package's model and the port's, on the same mesh."""
    ref = ref_adjoint.build_adjoint_model(ref_device, **kwargs)
    port = adjoint.build_adjoint_model(
        st.device_from_reference(ref_device), torch_device="cpu", **kwargs
    )
    return ref, port


def _port_params(ref_params):
    return st.adjoint_params_from_reference(ref_params, F64, "cpu")


def _check_forward(ref_out, port_out, keys=("stream", "current_density", "self_field"),
                   rtol=FORWARD_RTOL):
    for film, fields in ref_out.items():
        for key in keys:
            assert _rel_err(port_out[film][key], fields[key]) < rtol, (film, key)


def _direction(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _ring_device(Lambda=0.8):
    device = sc.Device(
        "ring",
        layers=[sc.Layer("base", Lambda=Lambda, z0=0)],
        films=[sc.Polygon("ring", layer="base", points=sc.geometry.circle(1.5))],
        holes=[sc.Polygon("hole", layer="base", points=sc.geometry.circle(0.5))],
        solve_dtype="float64",
    )
    device.make_mesh(min_points=500)
    return device


@pytest.fixture(scope="module")
def ring():
    return _ring_device()


@pytest.fixture(scope="module")
def ring_models(ring):
    return _models(ring, field_units="mT", current_units="mA")


def test_adjoint_matches_reference_and_solve(ring, ring_models):
    ref_model, model = ring_models
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.3))
    ref_params["circulating_currents"]["hole"] = np.float64(0.7)
    params = model.default_params(applied_field=st.sources.ConstantField(0.3))
    params["circulating_currents"]["hole"] = torch.tensor(0.7, dtype=F64)
    for group in ("Lambda", "applied_field"):
        assert _rel_err(params[group]["ring"], ref_params[group]["ring"]) < 1e-14
    ref = jax.jit(ref_model.forward_fn(0))(ref_params)
    out = model.forward_fn(0)(params)
    _check_forward(ref, out)
    assert float(out["ring"]["field_from_other_films"].abs().max()) == 0.0
    sol = st.solve(
        st.device_from_reference(ring), applied_field=st.sources.ConstantField(0.3),
        field_units="mT", current_units="mA", circulating_currents={"hole": "0.7 mA"},
        torch_device="cpu",
    )[-1]
    fs = sol.film_solutions["ring"]
    for key in ("stream", "current_density", "self_field"):
        assert _rel_err(out["ring"][key], getattr(fs, key)) < FORWARD_RTOL, key


def test_adjoint_grad_lambda_against_jax_and_finite_difference(ring_models):
    ref_model, model = ring_models
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.5))
    ref_params["circulating_currents"]["hole"] = np.float64(0.2)
    params = _port_params(ref_params)
    ref_fwd, fwd = jax.jit(ref_model.forward_fn(0)), model.forward_fn(0)

    def ref_loss(lam):
        return jnp.sum(ref_fwd({**ref_params, "Lambda": {"ring": lam}})["ring"]["self_field"] ** 2)

    def loss(lam):
        return torch.sum(fwd({**params, "Lambda": {"ring": lam}})["ring"]["self_field"] ** 2)

    lam0 = params["Lambda"]["ring"].clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss(lam0), lam0)
    ref_grad = jax.grad(ref_loss)(jnp.asarray(ref_params["Lambda"]["ring"]))
    assert _rel_err(grad, ref_grad) < GRAD_RTOL
    v = torch.as_tensor(_direction(model.films["ring"].n, 0))
    eps = 1e-5
    with torch.no_grad():
        fd = (loss(lam0 + eps * v) - loss(lam0 - eps * v)) / (2 * eps)
    ad = torch.dot(grad, v)
    assert abs(float(fd - ad)) / abs(float(ad)) < 1e-6


def test_adjoint_grad_drives_against_jax_and_finite_difference(ring_models):
    """Gradients with respect to the circulating current and the
    applied-field amplitude."""
    ref_model, model = ring_models
    ref_base = ref_model.default_params(applied_field=sc.sources.ConstantField(1.0))
    base = _port_params(ref_base)
    ref_fwd, fwd = jax.jit(ref_model.forward_fn(0)), model.forward_fn(0)
    ref_hz = jnp.asarray(ref_base["applied_field"]["ring"])
    hz = base["applied_field"]["ring"]
    ref_w, w = ref_model.films["ring"].weights, model.films["ring"].weights

    def ref_loss(drives):
        I_circ, amp = drives
        out = ref_fwd({**ref_base, "applied_field": {"ring": amp * ref_hz},
                       "circulating_currents": {"hole": I_circ}})
        return jnp.sum(ref_w * (out["ring"]["self_field"] + amp * ref_hz) ** 2)

    def loss(drives):
        I_circ, amp = drives
        out = fwd({**base, "applied_field": {"ring": amp * hz},
                   "circulating_currents": {"hole": I_circ}})
        return torch.sum(w * (out["ring"]["self_field"] + amp * hz) ** 2)

    drives0 = torch.tensor([0.4, 0.8], dtype=F64, requires_grad=True)
    (grad,) = torch.autograd.grad(loss(drives0), drives0)
    assert _rel_err(grad, jax.grad(ref_loss)(jnp.array([0.4, 0.8]))) < GRAD_RTOL
    for k in range(2):
        e = torch.zeros(2, dtype=F64)
        e[k] = 1e-5
        with torch.no_grad():
            fd = (loss(drives0 + e) - loss(drives0 - e)) / 2e-5
        assert abs(float(fd - grad[k])) / max(abs(float(grad[k])), 1e-12) < 1e-5


def test_adjoint_vortex_matches_reference_and_grad(ring):
    vortices = [sc.Vortex(x=0.9, y=0.35, film="ring", nPhi0=2.0)]
    ref_model = ref_adjoint.build_adjoint_model(
        ring, vortices=vortices, field_units="mT", current_units="mA"
    )
    model = adjoint.build_adjoint_model(
        st.device_from_reference(ring), vortices=[st.Vortex(x=0.9, y=0.35, film="ring", nPhi0=2.0)],
        field_units="mT", current_units="mA", torch_device="cpu",
    )
    ref_params = ref_model.default_params()
    params = model.default_params()
    assert _rel_err(params["vortex_nPhi0"]["ring"], ref_params["vortex_nPhi0"]["ring"]) == 0
    ref_fwd, fwd = jax.jit(ref_model.forward_fn(0)), model.forward_fn(0)
    _check_forward(ref_fwd(ref_params), fwd(params))

    def ref_loss(nphi0):
        return jnp.sum(ref_fwd({**ref_params, "vortex_nPhi0": {"ring": nphi0}})["ring"]["stream"])

    def loss(nphi0):
        return torch.sum(fwd({**params, "vortex_nPhi0": {"ring": nphi0}})["ring"]["stream"])

    nphi0 = torch.tensor([2.0], dtype=F64, requires_grad=True)
    (grad,) = torch.autograd.grad(loss(nphi0), nphi0)
    assert _rel_err(grad, jax.grad(ref_loss)(jnp.array([2.0]))) < GRAD_RTOL
    # The response is linear in nPhi0, so the gradient is the secant.
    with torch.no_grad():
        secant = loss(torch.tensor([3.0], dtype=F64)) - loss(torch.tensor([2.0], dtype=F64))
    assert abs(float(grad[0] - secant)) / abs(float(secant)) < 1e-9


def test_adjoint_inhomogeneous_lambda_matches_reference_and_grad():
    """The (grad Lambda) . grad term of A(Lambda), forward and backward."""
    lam = sc.Parameter(lambda x, y: 0.5 + 0.3 * x**2 + 0.1 * y)
    device = sc.Device(
        "disk",
        layers=[sc.Layer("base", Lambda=lam, z0=0)],
        films=[sc.Polygon("disk", layer="base", points=sc.geometry.circle(1.2))],
        solve_dtype="float64",
    )
    device.make_mesh(min_points=400)
    ref_model, model = _models(device, field_units="mT", current_units="mA")
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.4))
    params = model.default_params(applied_field=st.sources.ConstantField(0.4))
    assert _rel_err(params["Lambda"]["disk"], ref_params["Lambda"]["disk"]) < 1e-14
    ref_fwd, fwd = jax.jit(ref_model.forward_fn(0)), model.forward_fn(0)
    _check_forward(ref_fwd(ref_params), fwd(params))

    def ref_loss(lam):
        return jnp.sum(ref_fwd({**ref_params, "Lambda": {"disk": lam}})["disk"]["stream"] ** 2)

    lam0 = params["Lambda"]["disk"].clone().requires_grad_()
    out = fwd({**params, "Lambda": {"disk": lam0}})
    (grad,) = torch.autograd.grad(torch.sum(out["disk"]["stream"] ** 2), lam0)
    ref_grad = jax.grad(ref_loss)(jnp.asarray(ref_params["Lambda"]["disk"]))
    assert _rel_err(grad, ref_grad) < GRAD_RTOL


@pytest.fixture(scope="module")
def two_layer():
    device = sc.Device(
        "two_rings",
        layers=[sc.Layer("bottom", Lambda=0.5, z0=0), sc.Layer("top", Lambda=0.8, z0=0.6)],
        films=[
            sc.Polygon("big_ring", layer="bottom", points=sc.geometry.circle(1.6)),
            sc.Polygon("little_ring", layer="top", points=sc.geometry.circle(1.0)),
        ],
        holes=[
            sc.Polygon("big_hole", layer="bottom", points=sc.geometry.circle(0.6)),
            sc.Polygon("little_hole", layer="top", points=sc.geometry.circle(0.4)),
        ],
        solve_dtype="float64",
    )
    device.make_mesh(min_points=400)
    return device


def test_adjoint_two_layer_coupling_matches_reference_and_grad(two_layer):
    ref_model, model = _models(two_layer, field_units="mT", current_units="mA")
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.2))
    ref_params["circulating_currents"]["big_hole"] = np.float64(0.5)
    params = _port_params(ref_params)
    ref_fwd, fwd = jax.jit(ref_model.forward_fn(2)), model.forward_fn(2)
    _check_forward(ref_fwd(ref_params), fwd(params),
                   keys=("stream", "current_density", "self_field", "field_from_other_films"))
    sol = st.solve(
        st.device_from_reference(two_layer), applied_field=st.sources.ConstantField(0.2),
        field_units="mT", current_units="mA", circulating_currents={"big_hole": "0.5 mA"},
        iterations=2, coupling="exact", torch_device="cpu",
    )[-1]
    out = fwd(params)
    for film in ("big_ring", "little_ring"):
        fs = sol.film_solutions[film]
        assert _rel_err(out[film]["stream"], fs.stream) < 1e-9
        assert _rel_err(out[film]["field_from_other_films"], fs.field_from_other_films) < 1e-9

    # d/d(Lambda_top) of the flux through the bottom hole, which responds
    # only through the inter-film coupling.
    ref_w, w = ref_model.films["big_ring"].weights, model.films["big_ring"].weights
    ref_mask, mask = ref_model.films["big_ring"].hole_masks[0], model.films["big_ring"].hole_masks[0]

    def ref_loss(lam_top):
        o = ref_fwd({**ref_params, "Lambda": {**ref_params["Lambda"], "little_ring": lam_top}})
        total = o["big_ring"]["self_field"] + o["big_ring"]["field_from_other_films"]
        return jnp.sum(ref_mask * ref_w * total)

    def loss(lam_top):
        o = fwd({**params, "Lambda": {**params["Lambda"], "little_ring": lam_top}})
        total = o["big_ring"]["self_field"] + o["big_ring"]["field_from_other_films"]
        return torch.sum(mask * w * total)

    lam0 = params["Lambda"]["little_ring"].clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss(lam0), lam0)
    ref_grad = jax.grad(ref_loss)(jnp.asarray(ref_params["Lambda"]["little_ring"]))
    assert _rel_err(grad, ref_grad) < GRAD_RTOL
    v = torch.as_tensor(_direction(model.films["little_ring"].n, 1))
    eps = 1e-5
    with torch.no_grad():
        fd = (loss(lam0 + eps * v) - loss(lam0 - eps * v)) / (2 * eps)
    ad = torch.dot(grad, v)
    assert abs(float(fd - ad)) / max(abs(float(ad)), 1e-12) < 1e-5


def _strip_device():
    width, height = 2.0, 6.0
    strip = sc.Polygon("strip", layer="base", points=sc.geometry.box(width, height, points=160))
    source = sc.Polygon("source", points=sc.geometry.box(width, height / 100, center=(0, height / 2)))
    drain = sc.Polygon("drain", points=sc.geometry.box(width, height / 100, center=(0, -height / 2)))
    device = sc.Device(
        "strip", layers=[sc.Layer("base", Lambda=0.5)], films=[strip],
        terminals={"strip": [source, drain]}, length_units="um", solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.3)
    return device


@pytest.fixture(scope="module")
def strip_models():
    device = _strip_device()
    return (device,) + _models(device, field_units="mT", current_units="mA", dtype="float64")


def test_adjoint_transport_matches_reference_and_solve(strip_models):
    strip, ref_model, model = strip_models
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.1))
    ref_params["terminal_currents"]["strip"] = np.array([1.0, -1.0])
    params = _port_params(ref_params)
    out = model.forward_fn(0)(params)
    _check_forward(jax.jit(ref_model.forward_fn(0))(ref_params), out)
    solution = st.solve(
        st.device_from_reference(strip), terminal_currents={"strip": {"source": "1 mA", "drain": "-1 mA"}},
        applied_field=st.sources.ConstantField(0.1), current_units="mA", field_units="mT",
        torch_device="cpu",
    )[-1]
    fs = solution.film_solutions["strip"]
    for key in ("stream", "current_density", "self_field"):
        assert _rel_err(out["strip"][key], getattr(fs, key)) < 1e-12, key


def test_adjoint_transport_grads_against_jax_and_finite_difference(strip_models):
    strip, ref_model, model = strip_models
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.1))
    ref_params["terminal_currents"]["strip"] = np.array([1.0, -1.0])
    params = _port_params(ref_params)
    ref_fwd, fwd = jax.jit(ref_model.forward_fn(0)), model.forward_fn(0)
    eps = 1e-5

    def ref_loss_current(I):
        p = {**ref_params, "terminal_currents": {"strip": jnp.stack([I, -I])}}
        return jnp.sum(ref_fwd(p)["strip"]["current_density"] ** 2)

    def loss_current(I):
        p = {**params, "terminal_currents": {"strip": torch.stack([I, -I])}}
        return torch.sum(fwd(p)["strip"]["current_density"] ** 2)

    I0 = torch.tensor(1.0, dtype=F64, requires_grad=True)
    (ad,) = torch.autograd.grad(loss_current(I0), I0)
    assert _rel_err(ad, jax.grad(ref_loss_current)(jnp.asarray(1.0))) < GRAD_RTOL
    with torch.no_grad():
        fd = (loss_current(I0 + eps) - loss_current(I0 - eps)) / (2 * eps)
    assert abs(float(ad) / float(fd) - 1) < 1e-7

    def ref_loss_lambda(lam):
        return jnp.sum(ref_fwd({**ref_params, "Lambda": {"strip": lam}})["strip"]["stream"] ** 2)

    def loss_lambda(lam):
        return torch.sum(fwd({**params, "Lambda": {"strip": lam}})["strip"]["stream"] ** 2)

    lam0 = params["Lambda"]["strip"].clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss_lambda(lam0), lam0)
    ref_grad = jax.grad(ref_loss_lambda)(jnp.asarray(ref_params["Lambda"]["strip"]))
    assert _rel_err(grad, ref_grad) < GRAD_RTOL
    v = torch.as_tensor(_direction(model.films["strip"].n, 0))
    with torch.no_grad():
        fd = (loss_lambda(lam0 + eps * v) - loss_lambda(lam0 - eps * v)) / (2 * eps)
    ad = torch.dot(grad, v)
    assert abs(float(fd - ad)) / max(abs(float(ad)), 1e-12) < 1e-5


def test_adjoint_transport_with_holes_matches_reference_and_grad():
    width, height = 1.0, 2.0
    slot_h, slot_w = height / 5, width / 4
    film = (
        sc.Polygon("film", layer="base", points=sc.geometry.box(width, height))
        .difference(sc.geometry.box(slot_w, slot_h, center=(-(width - slot_w) / 2, 0)))
        .difference(sc.geometry.box(slot_w, slot_h, center=(+(width - slot_w) / 2, 0)))
        .resample(151)
    )
    src = sc.Polygon("source", points=sc.geometry.box(width, height / 100, center=(0, height / 2)))
    drn = sc.Polygon("drain", points=sc.geometry.box(width, height / 100, center=(0, -height / 2)))
    hole = sc.Polygon("hole", layer="base", points=sc.geometry.circle(0.08, center=(0, 0.55)))
    device = sc.Device(
        "holey", layers=[sc.Layer("base", Lambda=0.5)], films=[film], holes=[hole],
        terminals={"film": [src, drn]}, length_units="um", solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.1)
    ref_model, model = _models(device, field_units="mT", current_units="mA", dtype="float64")
    assert model.films["film"].fwb_block is not None  # the second LU
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.2))
    ref_params["terminal_currents"]["film"] = np.array([1.0, -1.0])
    ref_params["circulating_currents"]["hole"] = np.asarray(0.3)
    params = _port_params(ref_params)
    ref_fwd, fwd = jax.jit(ref_model.forward_fn(0)), model.forward_fn(0)
    out = fwd(params)
    _check_forward(ref_fwd(ref_params), out)
    solution = st.solve(
        st.device_from_reference(device),
        terminal_currents={"film": {"source": "1 mA", "drain": "-1 mA"}},
        circulating_currents={"hole": "0.3 mA"}, applied_field=st.sources.ConstantField(0.2),
        current_units="mA", field_units="mT", torch_device="cpu",
    )[-1]
    fs = solution.film_solutions["film"]
    for key in ("stream", "current_density", "self_field"):
        assert _rel_err(out["film"][key], getattr(fs, key)) < 1e-12, key

    # Through the hole average and both LUs of the bootstrap.
    def ref_loss(lam, I):
        p = {**ref_params, "Lambda": {"film": lam}, "terminal_currents": {"film": jnp.stack([I, -I])}}
        return jnp.sum(ref_fwd(p)["film"]["stream"] ** 2)

    def loss(lam, I):
        p = {**params, "Lambda": {"film": lam}, "terminal_currents": {"film": torch.stack([I, -I])}}
        return torch.sum(fwd(p)["film"]["stream"] ** 2)

    lam0 = params["Lambda"]["film"].clone().requires_grad_()
    I0 = torch.tensor(1.0, dtype=F64, requires_grad=True)
    grads = torch.autograd.grad(loss(lam0, I0), (lam0, I0))
    ref_grads = jax.grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(ref_params["Lambda"]["film"]), jnp.asarray(1.0)
    )
    for grad, ref_grad in zip(grads, ref_grads):
        assert _rel_err(grad, ref_grad) < GRAD_RTOL


def test_adjoint_batch_of_lambdas_run_in_turn(ring_models):
    """The JAX test's ``vmap`` over Lambda, as a batch run in turn."""
    ref_model, model = ring_models
    ref_params = ref_model.default_params(applied_field=sc.sources.ConstantField(0.3))
    params = _port_params(ref_params)
    ref_fwd, fwd = ref_model.forward_fn(0), model.forward_fn(0)
    ref_lam0 = jnp.asarray(ref_params["Lambda"]["ring"])
    ref_lams = jnp.stack([ref_lam0 * s for s in (0.5, 1.0, 2.0)])
    ref = jax.jit(jax.vmap(
        lambda lam: ref_fwd({**ref_params, "Lambda": {"ring": lam}})["ring"]["stream"]
    ))(ref_lams)
    lam0 = params["Lambda"]["ring"]
    out = torch.stack([fwd({**params, "Lambda": {"ring": lam0 * s}})["ring"]["stream"]
                       for s in (0.5, 1.0, 2.0)])
    assert out.shape == (3, model.films["ring"].n)
    assert _rel_err(out, ref) < FORWARD_RTOL


def test_adjoint_batched_drives_equal_single_drives(two_layer):
    """A ``(B, n)`` applied field is B right-hand sides against one LU per
    film, through the coupling rounds; the gradient of a sum over the
    batch is the sum of the single-drive gradients."""
    model = adjoint.build_adjoint_model(
        st.device_from_reference(two_layer), field_units="mT", current_units="mA",
        torch_device="cpu",
    )
    params = model.default_params(applied_field=st.sources.ConstantField(0.2))
    params["circulating_currents"]["big_hole"] = torch.tensor(0.5, dtype=F64)
    scales = (0.5, 1.0, -2.0)
    fwd = model.forward_fn(2)
    lam = params["Lambda"]["little_ring"].clone().requires_grad_()
    batch = {name: torch.stack([s * h for s in scales]) for name, h in params["applied_field"].items()}
    out = fwd({**params, "applied_field": batch, "Lambda": {**params["Lambda"], "little_ring": lam}})
    (grad,) = torch.autograd.grad(torch.sum(out["big_ring"]["stream"] ** 2), lam)
    total = torch.zeros_like(grad)
    for b, s in enumerate(scales):
        lam_b = params["Lambda"]["little_ring"].clone().requires_grad_()
        single = fwd({**params, "applied_field": {k: s * h for k, h in params["applied_field"].items()},
                      "Lambda": {**params["Lambda"], "little_ring": lam_b}})
        for film in out:
            for key in out[film]:
                assert out[film][key].shape[0] == len(scales)
                assert _rel_err(out[film][key][b], single[film][key].detach()) < 1e-12, (film, key)
        total += torch.autograd.grad(torch.sum(single["big_ring"]["stream"] ** 2), lam_b)[0]
    assert _rel_err(grad, total) < 1e-12


def test_adjoint_contracts(ring):
    device = st.device_from_reference(ring)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            adjoint.build_adjoint_model(device)
    unmeshed = device.copy(with_mesh=False)
    with pytest.raises(ValueError, match="mesh"):
        adjoint.build_adjoint_model(unmeshed, torch_device="cpu")
    model = adjoint.build_adjoint_model(device, torch_device="cpu", dtype="float32")
    assert model.dtype == torch.float32 and model.films["ring"].Qw.dtype == torch.float32
    out = model.forward_fn(0)(model.default_params(applied_field=st.sources.ConstantField(0.3)))
    assert out["ring"]["stream"].dtype == torch.float32


# --- torch.autograd.gradcheck of the Functions, tiny sizes -------------------


def _tiny_sparse(rng, n_rows, n_cols, nnz):
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    return rows, cols


@pytest.mark.parametrize("batch", [(), (3,)], ids=["vector", "rows"])
def test_gradcheck_sparse_matvec(batch):
    rng = np.random.default_rng(5)
    rows, cols = _tiny_sparse(rng, 7, 9, 25)  # duplicates and empty rows included
    pattern = autograd.SparsePattern.from_coo(rows, cols, (7, 9), "cpu")
    vals = torch.as_tensor(rng.standard_normal(25), dtype=F64).requires_grad_()
    x = torch.as_tensor(rng.standard_normal(batch + (9,)), dtype=F64).requires_grad_()
    dense = torch.zeros((7, 9), dtype=F64).index_put_(
        (torch.as_tensor(rows), torch.as_tensor(cols)), vals.detach(), accumulate=True
    )
    y = autograd.SparseMatvec.apply(vals, x, pattern)
    assert _rel_err(y, (x.detach() @ dense.T).numpy()) < 1e-14
    assert torch.autograd.gradcheck(
        lambda v, u: autograd.SparseMatvec.apply(v, u, pattern), (vals, x)
    )


def test_gradcheck_brandt_solve():
    rng = np.random.default_rng(6)
    n = 9
    index = np.array([0, 2, 3, 5, 6, 8])
    dense = torch.as_tensor(rng.standard_normal((n, n)) - 6 * np.eye(n), dtype=F64)
    rows, cols = _tiny_sparse(rng, n, n, 30)
    keys = np.unique(rows * n + cols)
    rows, cols = keys // n, keys % n
    pattern = autograd.SparsePattern.from_coo(rows, cols, (n, n), "cpu")
    block = adjoint.SystemBlock.build(index, rows, cols, n, F64, "cpu")
    vals = torch.as_tensor(0.3 * rng.standard_normal(len(rows)), dtype=F64).requires_grad_()
    rhs = torch.as_tensor(rng.standard_normal((2, n)), dtype=F64).requires_grad_()

    def solve(v, r):
        system = block.factor(dense, v.detach())  # the cache follows vals
        return autograd.BrandtSolve.apply(r, v, system, pattern)

    A = dense.clone()
    A[torch.as_tensor(rows), torch.as_tensor(cols)] += vals.detach()
    ix = torch.as_tensor(index)
    x = solve(vals, rhs).detach()
    expected = torch.linalg.solve(-A[ix][:, ix], rhs.detach()[:, ix].T).T
    assert _rel_err(x[:, ix], expected.numpy()) < 1e-12
    outside = np.setdiff1d(np.arange(n), index)
    assert float(x[:, outside].abs().max()) == 0.0
    assert torch.autograd.gradcheck(solve, (vals, rhs))


@pytest.mark.parametrize("B,dz2", [(1, 0.0), (2, 0.25)])
def test_gradcheck_biot_savart_coupling(B, dz2):
    rng = np.random.default_rng(7 + B)
    src = torch.as_tensor(rng.uniform(-1, 1, (6, 2)), dtype=F64)
    dst = torch.as_tensor(rng.uniform(-1, 1, (5, 2)), dtype=F64)
    areas = torch.as_tensor(rng.uniform(0.1, 0.2, 6), dtype=F64)
    J = torch.as_tensor(rng.standard_normal((B, 6, 2)), dtype=F64).requires_grad_()

    def field(current):
        return autograd.BiotSavartCoupling.apply(current, src, areas, dst, dz2)

    assert _rel_err(field(J), kernels.biot_savart_plain(src, areas, J.detach(), dst, dz2)) < 1e-14
    assert torch.autograd.gradcheck(field, (J,))
    # The swapped-roles VJP against plain autograd through the plain sum.
    g = torch.as_tensor(rng.standard_normal((B, 5)), dtype=F64)
    (vjp,) = torch.autograd.grad(field(J), J, g)
    (plain,) = torch.autograd.grad(kernels.biot_savart_plain(src, areas, J, dst, dz2), J, g)
    assert _rel_err(vjp, plain) < 1e-13


def test_gradcheck_dense_product():
    rng = np.random.default_rng(8)
    W = torch.as_tensor(rng.standard_normal((4, 6)), dtype=F64)
    x = torch.as_tensor(rng.standard_normal((2, 6)), dtype=F64).requires_grad_()
    assert torch.autograd.gradcheck(lambda u: autograd.DenseProduct.apply(u, W), (x,))

"""The port's multi-device layer (``superscreen_tpu_torch.parallel``) against
its own unsharded functions and the JAX package's sharded ones, at float64
on the CPU: the port on ``make_mesh(devices=["cpu"] * 8)``, the JAX package
on its 8 virtual devices (``tests/conftest.py``), the same seeded inputs,
and the JAX tests' own bars (``tests/test_sweep.py``)."""

import importlib
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu import parallel as jpar
from superscreen_tpu.ops import linalg as jlinalg
from superscreen_tpu.sweep import _film_sweep_data, _run_sweep as jax_run_sweep
from superscreen_tpu_torch import parallel as ppar
from superscreen_tpu_torch.ops import kernels as pkernels
from superscreen_tpu_torch.ops import rows as prows
from superscreen_tpu_torch.parallel import sharding as psharding
from superscreen_tpu_torch.sweep import _run_sweep as port_run_sweep

solve_film = importlib.import_module("superscreen_tpu_torch.solver.solve_film")

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


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


@pytest.fixture(scope="module")
def rings():
    ref = _two_rings()
    port = st.device_from_reference(ref)
    return dict(
        ref=ref,
        ref_model=sc.factorize_model(device=ref, current_units="uA"),
        port=port,
        port_model=st.factorize_model(device=port, current_units="uA", torch_device="cpu"),
    )


def _close(a, b, rtol=1e-10, atol=1e-12):
    return np.allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_sharded_sweep_matches_unsharded_and_jax(rings):
    """tests/test_sweep.py::test_sharded_sweep through both packages."""
    assert len(jax.devices()) >= 2, "conftest must provide the 8-virtual-device mesh"
    films = list(rings["ref"].films)
    mesh = ppar.make_mesh(n_data=4, n_model=2, devices=CPU8)
    jmesh = jpar.make_mesh(n_data=4, n_model=2)
    port_data = rings["port_model"].film_data
    jax_data = {name: _film_sweep_data(rings["ref_model"], name) for name in films}
    B = mesh.shape["data"] * 2
    Hz = {name: np.linspace(0.1, 1.0, B)[:, None] * np.ones(port_data[name].n)[None, :] for name in films}
    I_circ = {name: np.zeros((B, len(port_data[name].hole_names))) for name in films}
    ref = port_run_sweep(
        port_data, {k: torch.as_tensor(v) for k, v in Hz.items()},
        {k: torch.as_tensor(v) for k, v in I_circ.items()}, 1645.5, 1, 1,
    )
    sharded = ppar.sharded_film_data(port_data, mesh)
    assert isinstance(sharded, psharding.ShardedFilmData) and len(sharded.rows) == 4
    for name in films:
        Qw = sharded[name].Qw
        assert isinstance(Qw, prows.RowSharded) and len(Qw.blocks) == mesh.shape["model"]
        assert Qw.shape[0] % mesh.shape["model"] == 0
        assert {b.shape[0] for b in Qw.blocks} == {Qw.shape[0] // 2}
        assert isinstance(sharded[name].A, prows.RowSharded)
    Hz_s, I_s = ppar.shard_sweep_inputs(Hz, I_circ, mesh, film_data=sharded)
    out = port_run_sweep(sharded, Hz_s, I_s, 1645.5, 1, 1)
    jax_sharded = jpar.sharded_film_data(jax_data, jmesh)
    jHz, jI = jpar.shard_sweep_inputs(Hz, I_circ, jmesh, film_data=jax_sharded)
    jout = jax_run_sweep(jax_sharded, jHz, jI, 1645.5, 1, 1)
    for name in films:
        n = port_data[name].n
        for quantity in range(4):
            b = np.asarray(out[quantity][name])
            assert _close(ref[quantity][name], b[:, :n]), (name, quantity)
            assert _close(b, jout[quantity][name]), (name, quantity)
        # Padded sites carry exactly zero stream.
        assert np.all(np.asarray(out[0][name])[:, n:] == 0.0)


def test_make_mesh_validation():
    with pytest.raises(ValueError):
        ppar.make_mesh(n_data=9, n_model=1, devices=CPU8)
    mesh = ppar.make_mesh(devices=CPU8)
    assert mesh.shape["data"] * mesh.shape["model"] == 8
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (8, 1)
    assert ppar.batch_sharding(mesh).spec == ("data",)
    assert ppar.replicated_sharding(mesh).spec == ()
    with pytest.raises(ValueError, match="cpu or cuda"):
        ppar.make_mesh(devices=["meta"] * 2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_make_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ppar.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ppar.make_mesh(n_data=1)


def test_sharded_biot_savart_matches_unsharded_and_jax():
    """dst rows over 'model', batch over 'data', non-divisible shapes."""
    mesh = ppar.make_mesh(n_data=4, n_model=2, devices=CPU8)
    rng = np.random.default_rng(0)
    n1, n2, B = 501, 643, mesh.shape["data"] * 2 + 1
    src = rng.uniform(-10, 10, (n1, 2))
    dst = rng.uniform(-10, 10, (n2, 2))
    areas = rng.uniform(0.01, 0.02, n1)
    J = rng.normal(size=(B, n1, 2))
    out = np.asarray(ppar.sharded_biot_savart(mesh, src, areas, J, dst, 1.7))
    ref = pkernels.biot_savart_film_to_film_dz2(*(torch.as_tensor(a) for a in (src, areas, J, dst)), 1.7)
    assert out.shape == (B, n2)
    assert np.abs(out - ref.numpy()).max() <= 1e-12 * np.abs(ref.numpy()).max()
    jout = np.asarray(jpar.sharded_biot_savart(jpar.make_mesh(n_data=4, n_model=2), src, areas, J, dst, 1.7))
    assert np.abs(out - jout).max() <= 1e-12 * np.abs(jout).max()


def test_sharded_self_field_matches_unsharded_and_jax(rings):
    """The row-sharded self-field matches Q @ (w g) on one device."""
    mesh = ppar.make_mesh(n_data=4, n_model=2, devices=CPU8)
    m = rings["ref"].meshes["big_ring"]
    sites, weights = m.sites, np.asarray(m.operators.weights)
    rng = np.random.default_rng(1)
    B = mesh.shape["data"] + 1
    g = rng.normal(size=(B, len(sites)))
    out = np.asarray(ppar.sharded_self_field(mesh, sites, weights, g))
    w = torch.as_tensor(weights)
    ref = pkernels.Q_apply(torch.as_tensor(sites), w, (w[None, :] * torch.as_tensor(g)).T).T.numpy()
    assert np.abs(out - ref).max() <= 1e-10 * np.abs(ref).max()
    diag = ppar.self_field_diagonal(mesh, sites, weights)
    again = np.asarray(ppar.sharded_self_field(mesh, sites, weights, g, diag=diag))
    assert np.array_equal(again, out)
    jout = np.asarray(jpar.sharded_self_field(jpar.make_mesh(n_data=4, n_model=2), sites, weights, g))
    assert np.abs(out - jout).max() <= 1e-10 * np.abs(jout).max()


@pytest.mark.parametrize(
    "n_data,n_model,options",
    [
        (8, 1, dict()),
        (4, 2, dict()),
        (3, 2, dict(keep_history=True)),
        (2, 4, dict(final_refine=1)),
        (4, 2, dict(coupling="fft")),
    ],
    ids=["data8", "data4-model2", "history", "final-refine", "fft"],
)
def test_solve_many_sharding_arg(rings, n_data, n_model, options):
    """solve_many(sharding=...) over the data axis matches the unsharded
    sweep, and the JAX package's sharded one."""
    mesh = ppar.make_mesh(n_data=n_data, n_model=n_model, devices=["cpu"] * (n_data * n_model))
    values = np.linspace(0.2, 1.0, 8)
    kwargs = dict(field_units="mT", iterations=1, **options)
    circ = [{"big_hole": 2.0 * v} for v in values]
    ref = st.solve_many(
        model=rings["port_model"], applied_fields=[st.sources.ConstantField(v) for v in values],
        circulating_currents=circ, torch_device="cpu", **kwargs,
    )
    out = st.solve_many(
        model=rings["port_model"], applied_fields=[st.sources.ConstantField(v) for v in values],
        circulating_currents=circ, sharding=ppar.batch_sharding(mesh), torch_device="cpu", **kwargs,
    )
    refs, outs = (r if isinstance(r, list) else [r] for r in (ref, out))
    for r, o in zip(refs, outs):
        for film in rings["ref"].films:
            for quantity in ("streams", "current_densities", "self_fields", "other_fields"):
                assert _close(getattr(o, quantity)[film], getattr(r, quantity)[film]), (film, quantity)
    if "final_refine" in options:
        assert out.final_refine_report["residual_rel_max_after"] <= 1e-10
    if options or n_model > 1:
        return
    jmesh = jpar.make_mesh(n_data=len(jax.devices()), n_model=1)
    jout = sc.solve_many(
        model=rings["ref_model"], applied_fields=[sc.sources.ConstantField(v) for v in values],
        circulating_currents=circ, sharding=jpar.batch_sharding(jmesh), **kwargs,
    )
    for film in rings["ref"].films:
        assert _close(out.streams[film], jout.streams[film])


def test_solve_many_refuses_a_bad_sharding(rings):
    fields = [st.sources.ConstantField(0.1)] * 2
    with pytest.raises(TypeError, match="NamedSharding"):
        st.solve_many(model=rings["port_model"], applied_fields=fields, sharding=object(),
                      torch_device="cpu")
    mesh = ppar.make_mesh(n_data=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="'data'"):
        st.solve_many(model=rings["port_model"], applied_fields=fields,
                      sharding=ppar.replicated_sharding(mesh), torch_device="cpu")
    meta = psharding.DeviceMesh(np.array([[torch.device("meta")]], dtype=object))
    with pytest.raises(ValueError, match="meta"):
        st.solve_many(model=rings["port_model"], applied_fields=fields,
                      sharding=ppar.batch_sharding(meta), torch_device="cpu")


def _spd_system(seed, n):
    rng = np.random.default_rng(seed)
    sites = rng.uniform(-1, 1, size=(n, 2))
    d = np.linalg.norm(sites[:, None] - sites[None, :], axis=-1) + np.eye(n)
    P = 1.0 / d + n * np.eye(n)  # SPD, kernel-like
    P = 0.5 * (P + P.T)
    w = rng.uniform(0.5, 1.5, size=n)
    return -(P * w[None, :]), w, rng


@pytest.mark.parametrize("method", ["schur", "schulz"])
def test_sharded_spd_inverse_matches_single_device(method):
    """tests/test_sweep.py::test_sharded_spd_inverse_matches_single_device:
    both bodies match the single-device inverse and invert the system."""
    neg_A, w, rng = _spd_system(2, 96)
    mesh = ppar.make_mesh(n_data=4, n_model=2, devices=CPU8)
    M = ppar.sharded_spd_inverse(mesh, neg_A, w, method=method)
    assert isinstance(M, prows.RowSharded) and len(M.blocks) == 2
    M_sharded = np.asarray(M)
    M_single = np.asarray(jlinalg._jax_spd_inverse(neg_A, w))
    assert np.allclose(M_sharded, M_single, rtol=1e-9, atol=1e-12)
    assert np.allclose(M_sharded, np.linalg.inv(neg_A), rtol=1e-9, atol=1e-12)
    jM = np.asarray(jpar.sharded_spd_inverse(jpar.make_mesh(n_data=4, n_model=2), neg_A, w, method=method))
    assert np.allclose(M_sharded, jM, rtol=1e-9, atol=1e-12)
    h = rng.standard_normal(96)
    x = (M @ torch.as_tensor(h)).numpy()
    assert np.allclose(neg_A @ x, h, rtol=1e-6, atol=1e-9)


def test_sharded_spd_inverse_validates_method_before_copying(monkeypatch):
    sent = []
    monkeypatch.setattr(prows, "_send", lambda t, d: sent.append(t) or t.to(d))
    mesh = ppar.make_mesh(n_data=1, n_model=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="sharded factorization method"):
        ppar.sharded_spd_inverse(mesh, np.eye(4), np.ones(4), method="lu")
    monkeypatch.setenv("SUPERSCREEN_TPU_SHARDED_FACTOR", "nope")
    with pytest.raises(ValueError, match="nope"):
        ppar.sharded_spd_inverse(mesh, np.eye(4), np.ones(4))
    assert not sent


@pytest.mark.parametrize("n,leaf", [(300, 64), (256, 64), (40, 64)], ids=["recursion", "ragged", "leaf"])
def test_schur_inverse_panels_and_leaf(n, leaf):
    """tests/test_sweep.py::test_schur_inverse_recursion_and_padding: the
    row-sharded Schur inverse over 4 slots (several pivot panels per
    slot, a ragged last panel, one panel per slot) matches the JAX
    package's Cholesky inverse."""
    rng = np.random.default_rng(7)
    G = rng.normal(size=(n, n))
    P = G @ G.T / n + 3.0 * np.eye(n)
    w = 0.5 + rng.random(n)
    neg_A = -(P * w[None, :])
    M_chol = np.asarray(jlinalg._jax_chol_explicit_inverse(neg_A, w, block=64))
    rows = prows.RowSharded.split(torch.as_tensor(neg_A), ["cpu"] * 4)
    M_schur = np.asarray(prows.schur_inverse_rows(rows, torch.as_tensor(w), sign=-1.0, leaf=leaf))
    assert np.abs(M_schur - M_chol).max() / np.abs(M_chol).max() < 1e-9


def _inverse_inputs(n, seed=3):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n))
    w = 0.5 + rng.random(n)
    return torch.as_tensor(-((G @ G.T / n + 3.0 * np.eye(n)) * w[None, :])), torch.as_tensor(w)


def test_sharded_inverse_products_run_panel_by_panel(monkeypatch):
    """No slot holds more than its own rows or one incoming row block
    (n_p^2 / n_model elements) at any point of the sharded inverse: every
    tensor that reaches a slot and every operand and result of a panel
    product with the symmetrised system is recorded."""
    n, n_model = 96, 4
    largest = []
    send, panel = prows._send, prows._sym_panel

    def recorded_send(t, device):
        largest.append(t.numel())
        return send(t, device)

    def recorded_panel(A, inv_w, sign, parts):
        out = panel(A, inv_w, sign, parts)
        largest.extend([p.numel() for p in parts] + [y.numel() for y in out])
        return out

    monkeypatch.setattr(prows, "_send", recorded_send)
    monkeypatch.setattr(prows, "_sym_panel", recorded_panel)
    neg_A, w = _inverse_inputs(n)
    mesh = ppar.make_mesh(n_data=1, n_model=n_model, devices=["cpu"] * n_model)
    for method in ("schur", "schulz"):
        largest.clear()
        M = ppar.sharded_spd_inverse(mesh, neg_A, w, method=method)
        assert np.allclose(np.asarray(M), np.linalg.inv(neg_A.numpy()), rtol=1e-9, atol=1e-12)
        assert largest and max(largest) <= n * n // n_model, (method, max(largest))


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


@pytest.mark.parametrize("method", ["schur", "schulz"])
def test_sharded_inverse_memory_within_its_ceiling(monkeypatch, method):
    """The sharded inverse holds at most PEAK_BLOCKS row-sharded n x n
    matrices at once, the caller's system among them, plus panels: every
    storage its ops make is tracked while it lives, over 4 slots with
    8-column panels.  At the raised dense ceiling of a 2-slot mesh that
    footprint per slot stays within the single-device budget
    MAX_MATERIALIZED_BYTES."""
    n, n_model, width = 256, 4, 8
    monkeypatch.setattr(prows, "PANEL", width)
    monkeypatch.setattr(prows, "SCHULZ_ITERS", 2)
    neg_A, w = _inverse_inputs(n)
    mesh = ppar.make_mesh(n_data=1, n_model=n_model, devices=["cpu"] * n_model)
    with _LiveBytes(ignore=[neg_A, w]) as tracker:
        M = ppar.sharded_spd_inverse(mesh, neg_A, w, method=method)
    if method == "schur":
        assert np.allclose(np.asarray(M), np.linalg.inv(neg_A.numpy()), rtol=1e-9, atol=1e-12)
    matrix = n * n * 8
    # Each slot's A_j^T V_j, one gathered (n, width) panel, and a few
    # (n / n_model, width) pieces: well under one more matrix.
    panels = (n_model + 6) * n * width * 8
    assert panels <= matrix // 3
    assert tracker.peak <= (prows.PEAK_BLOCKS - 1) * matrix + panels, tracker.peak / matrix
    assert tracker.peak > (prows.PEAK_BLOCKS - 2) * matrix  # the tracker sees the blocks

    monkeypatch.delenv("SUPERSCREEN_TPU_MAX_MATERIALIZED_N", raising=False)
    ppar.set_factorization_mesh(ppar.make_mesh(n_data=1, n_model=2, devices=["cpu"] * 2))
    try:
        single = solve_film.max_materialized_n(torch.float32)
        ceiling = solve_film._sharded_dense_ceiling(single)
    finally:
        ppar.set_factorization_mesh(None)
    assert ceiling > single
    assert prows.PEAK_BLOCKS * ceiling**2 * 4 / 2 <= solve_film.MAX_MATERIALIZED_BYTES


def test_row_sharded_gathers_and_aliases():
    A = torch.arange(35.0, dtype=torch.float64).reshape(7, 5)
    rows = prows.RowSharded.split(A, ["cpu"] * 3)
    assert [b.shape[0] for b in rows.blocks] == [3, 2, 2] and rows.shape == (7, 5)
    assert rows.bounds == [(0, 3), (3, 5), (5, 7)] and rows.dtype == torch.float64
    # On the matrix's own device the blocks are views: they cost no memory.
    assert all(b.data_ptr() == A[lo:].data_ptr() for b, (lo, _) in zip(rows.blocks, rows.bounds))
    assert np.array_equal(np.asarray(rows), A.numpy())
    assert torch.equal(rows.to_dense(), A)
    assert torch.equal(rows.take_rows(torch.tensor([0, 4, 6])), A[[0, 4, 6]])
    x = torch.linspace(-1, 1, 5, dtype=torch.float64)
    assert torch.allclose(rows @ x, A @ x, rtol=0, atol=1e-13)
    two = rows.reshard(["cpu"] * 2)
    assert [b.shape[0] for b in two.blocks] == [4, 3] and torch.equal(two.to_dense(), A)
    A32 = A.float()
    X = torch.randn(5, 3, dtype=torch.float64)
    H = torch.randn(7, 3, dtype=torch.float64)
    got = prows.RowSharded.split(A32, ["cpu"] * 3).residual_f64(X, H)
    assert torch.allclose(got, H + A32.double() @ X, rtol=0, atol=1e-12)


def test_q_matrix_rect_is_rows_of_the_square_matrix():
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.uniform(-3, 3, (301, 2)))
    full = pkernels.q_matrix(pts)
    for r0, r1 in [(0, 301), (37, 150), (299, 301), (5, 5)]:
        block = pkernels.q_matrix_rect(pts[r0:r1], pts)
        assert torch.equal(block, full[r0:r1])
        assert bool((block[:, r0:r1].diagonal() == 0).all())


def test_factorization_mesh_install_and_clear():
    mesh = ppar.make_mesh(n_data=4, n_model=2, devices=CPU8)
    ppar.set_factorization_mesh(mesh)
    try:
        assert ppar.factorization_mesh() is mesh
        assert psharding.factorization_row_sharding().spec == ("model", None)
        assert solve_film._sharded_dense_ceiling(1000) == int(1000 * 2**0.5)
    finally:
        ppar.set_factorization_mesh(None)
    assert ppar.factorization_mesh() is None
    assert psharding.factorization_row_sharding() is None
    assert solve_film._sharded_dense_ceiling(1000) == 1000
    with pytest.raises(ValueError, match="factorization mesh"):
        st.ops.linalg.factor_system(torch.eye(3), torch.ones(3), force_sharded=True)


def _disk(pkg):
    dev = pkg.Device(
        "disk",
        layers=[pkg.Layer("L", Lambda=1.0, z0=0)],
        films=[pkg.Polygon("disk", layer="L", points=pkg.geometry.circle(4.0, points=80))],
        solve_dtype="float64",
    )
    dev.make_mesh(min_points=600, smooth=3)
    return dev


def test_auto_sharded_dense_dispatch(monkeypatch):
    """tests/test_sweep.py::test_auto_sharded_dense_dispatch: a film past
    the single-device dense ceiling stays dense when a factorization mesh
    is installed, assembled and inverted row-sharded, and its solve
    matches the plain dense solve and the JAX package's sharded one."""
    from superscreen_tpu.solver import utils as ref_utils
    from superscreen_tpu_torch.solver import utils as port_utils

    ref_dev = _disk(sc)
    dev = st.device_from_reference(ref_dev)
    monkeypatch.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    monkeypatch.setattr(ref_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    plain = st.factorize_model(device=dev, current_units="mA", torch_device="cpu")
    ni = len(plain.film_systems["disk"].indices)
    ceiling = int(0.8 * ni)
    monkeypatch.setenv("SUPERSCREEN_TPU_MAX_MATERIALIZED_N", str(ceiling))
    cg_model = st.factorize_model(device=dev, current_units="mA", torch_device="cpu")
    assert cg_model.film_systems["disk"].cg_op is not None
    field = dict(applied_field=st.sources.ConstantField(0.5), field_units="mT", progress_bar=False)
    ppar.set_factorization_mesh(ppar.make_mesh(n_data=4, n_model=2, devices=CPU8))
    jpar.set_factorization_mesh(jpar.make_mesh(n_data=4, n_model=2))
    try:
        assert ni <= int(ceiling * 2**0.5)
        model = st.factorize_model(device=dev, current_units="mA", torch_device="cpu")
        system = model.film_systems["disk"]
        kind, M, w = system.lu_piv
        assert kind == "inv" and model.film_data["disk"].fac_kind == "inv"
        for op in (M, system.A):
            assert isinstance(op, prows.RowSharded) and len(op.blocks) == 2
            assert max(b.numel() for b in op.blocks) < ni * ni
        # Each slot's block of the system is those rows of the plain one.
        assert np.array_equal(np.asarray(system.A), plain.film_systems["disk"].A.numpy())
        ref = st.solve(model=plain, torch_device="cpu", **field)[-1]
        out = st.solve(model=model, torch_device="cpu", check_inversion=True, **field)[-1]
        a = ref.film_solutions["disk"].stream
        b = out.film_solutions["disk"].stream
        assert np.abs(a - b).max() < 1e-8 * np.abs(a).max()
        jmodel = sc.factorize_model(device=ref_dev, current_units="mA")
        assert jmodel.film_systems["disk"].lu_piv[0] == "inv"
        jout = sc.solve(model=jmodel, applied_field=sc.sources.ConstantField(0.5), field_units="mT",
                        progress_bar=False)[-1]
        c = jout.film_solutions["disk"].stream
        assert np.abs(b - c).max() < 1e-8 * np.abs(c).max()
        # The certificate and the polish treat the film as the JAX package does.
        result = st.solve_many(model=model, applied_fields=[st.sources.ConstantField(0.5)],
                               final_refine=1, torch_device="cpu")
        assert result.final_refine_report["per_film"]["disk"]["residual_rel_after"] < 1e-12
    finally:
        ppar.set_factorization_mesh(None)
        jpar.set_factorization_mesh(None)

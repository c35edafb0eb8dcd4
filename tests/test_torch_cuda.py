"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``gpu`` and skips without a CUDA
device.  This file imports neither JAX nor ``superscreen_tpu``, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import superscreen_tpu_torch as st
from superscreen_tpu_torch.ops import cuda_kernels, kernels

pytestmark = pytest.mark.gpu

# Relative to max|plain|: float32 terms round at ~6e-8 and are summed in
# other orders; float64 at ~1.1e-16.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
def test_q_matrix_kernel_matches_plain(cuda, dtype, n):
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.uniform(-5, 5, (n, 2)), dtype=dtype, device=cuda)
    out = cuda_kernels.q_matrix(pts)
    ref = kernels.q_matrix_plain(pts)
    torch.cuda.synchronize()
    assert out.shape == (n, n)
    assert bool((out.diagonal() == 0).all())
    if n > 1:
        assert _rel_err(out, ref) <= TOL[dtype]


# Batch and column counts on both sides of each chunk width (1, 2, 4, 8).
CHUNK_EDGES = [1, 2, 3, 4, 5, 7, 8, 9, 16, 17]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", CHUNK_EDGES)
def test_biot_savart_kernel_matches_plain(cuda, dtype, B):
    rng = np.random.default_rng(B)
    n1, n2 = 3001, 1777
    src = torch.as_tensor(rng.uniform(-5, 5, (n1, 2)), dtype=dtype, device=cuda)
    dst = torch.as_tensor(rng.uniform(-4, 4, (n2, 2)), dtype=dtype, device=cuda)
    areas = torch.as_tensor(rng.uniform(0.01, 0.02, n1), dtype=dtype, device=cuda)
    J = torch.as_tensor(rng.standard_normal((B, n1, 2)), dtype=dtype, device=cuda)
    for dz2 in (0.25, 1.0):
        out = cuda_kernels.biot_savart_batch(src, areas, J, dst, dz2)
        ref = kernels.biot_savart_plain(src, areas, J, dst, dz2)
        torch.cuda.synchronize()
        assert out.shape == (B, n2)
        assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "m,n,k",
    [(1, 2, 1), (1777, 1777, 1), (3001, 1777, 7), (500, 4099, 2), (1000, 1000, 11)]
    + [(700, 643, k) for k in CHUNK_EDGES],
)
def test_q_apply_kernel_matches_plain(cuda, dtype, m, n, k):
    rng = np.random.default_rng(m + n + k)
    src = torch.as_tensor(rng.uniform(-5, 5, (n, 2)), dtype=dtype, device=cuda)
    # The first third of the evaluation points coincide with sources.
    ev = torch.cat([src[: m // 3], torch.as_tensor(rng.uniform(-4, 4, (m - m // 3, 2)), dtype=dtype, device=cuda)])
    V = torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype, device=cuda)
    out = cuda_kernels.q_apply(ev, src, V)
    ref = kernels.q_apply_plain(ev, src, V)
    torch.cuda.synchronize()
    assert out.shape == (m, k) and bool(torch.isfinite(out).all())
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 2, 3, 8, 9])
def test_biot_savart_pair_kernel_matches_plain(cuda, dtype, B):
    rng = np.random.default_rng(10 + B)
    n1, n2 = 3001, 1777

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    s1, s2 = t(rng.uniform(-5, 5, (n1, 2))), t(rng.uniform(-4, 4, (n2, 2)))
    a1, a2 = t(rng.uniform(0.01, 0.02, n1)), t(rng.uniform(0.01, 0.02, n2))
    J1, J2 = t(rng.standard_normal((B, n1, 2))), t(rng.standard_normal((B, n2, 2)))
    for dz2 in (0.25, 1.0):
        at2, at1 = cuda_kernels.biot_savart_pair(s1, a1, J1, s2, a2, J2, dz2)
        ref2, ref1 = kernels.biot_savart_pair_plain(s1, a1, J1, s2, a2, J2, dz2)
        torch.cuda.synchronize()
        assert at2.shape == (B, n2) and at1.shape == (B, n1)
        assert _rel_err(at2, ref2) <= TOL[dtype]
        assert _rel_err(at1, ref1) <= TOL[dtype]
        # The same fields as two one-way passes of biot_savart_batch.
        assert _rel_err(at1, cuda_kernels.biot_savart_batch(s2, a2, J2, s1, dz2)) <= TOL[dtype]


# Evaluation counts around the block of threads x points per thread (128
# threads; 4 points each in float32, 2 in float64) and source counts around
# the 128-point tile and the unrolled step of 4 (float32) or 2 (float64).
BLOCK_EDGES = [(1, 1), (1, 131), (127, 128), (255, 257), (257, 383), (511, 130), (513, 129),
               (1025, 385), (2049, 131)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", BLOCK_EDGES)
def test_q_apply_kernel_ragged_blocks_and_tiles(cuda, dtype, m, n):
    rng = np.random.default_rng(7 * m + n)
    src = torch.as_tensor(rng.uniform(-5, 5, (n, 2)), dtype=dtype, device=cuda)
    ev = torch.as_tensor(rng.uniform(-4, 4, (m, 2)), dtype=dtype, device=cuda)
    for k in (1, 3):
        V = torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype, device=cuda)
        out = cuda_kernels.q_apply(ev, src, V)
        ref = kernels.q_apply_plain(ev, src, V)
        torch.cuda.synchronize()
        assert out.shape == (m, k) and bool(torch.isfinite(out).all())
        assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", BLOCK_EDGES)
def test_biot_savart_kernel_ragged_blocks_and_tiles(cuda, dtype, m, n):
    rng = np.random.default_rng(3 * m + n)
    src = torch.as_tensor(rng.uniform(-5, 5, (n, 2)), dtype=dtype, device=cuda)
    dst = torch.as_tensor(rng.uniform(-4, 4, (m, 2)), dtype=dtype, device=cuda)
    areas = torch.as_tensor(rng.uniform(0.01, 0.02, n), dtype=dtype, device=cuda)
    for B in (1, 3):
        J = torch.as_tensor(rng.standard_normal((B, n, 2)), dtype=dtype, device=cuda)
        out = cuda_kernels.biot_savart_batch(src, areas, J, dst, 0.25)
        ref = kernels.biot_savart_plain(src, areas, J, dst, 0.25)
        torch.cuda.synchronize()
        assert out.shape == (B, m) and bool(torch.isfinite(out).all())
        assert _rel_err(out, ref) <= TOL[dtype]


# Film-1 and film-2 counts around the pair kernel's 32-source group, its
# source tile (64 in float32 for chunks of 1-2 columns, 128 for 4-8; 128 in
# float64, 64 for chunks of 8) and its film-2 points per block (128 threads
# x 8 points in float32 for chunks of 1-2 columns, x 4 for 4-8; x 2 in
# float64).
PAIR_EDGES = [(1, 1), (31, 255), (33, 257), (63, 511), (65, 513), (127, 1023), (129, 1025),
              (255, 2047), (257, 2049), (1025, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1,n2", PAIR_EDGES)
def test_biot_savart_pair_kernel_ragged_blocks_and_groups(cuda, dtype, n1, n2):
    rng = np.random.default_rng(5 * n1 + n2)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    s1, a1 = t(rng.uniform(-5, 5, (n1, 2))), t(rng.uniform(0.01, 0.02, n1))
    a2 = t(rng.uniform(0.01, 0.02, n2))
    for dz2 in (0.0, 0.25):
        # At dz2 = 0 the films lie apart, so every real pair has r > 0 and
        # any padded pair at r = 0 would show as a non-finite output.
        s2 = t(rng.uniform(-4, 4, (n2, 2)) + (12.0 if dz2 == 0 else 0.0))
        for B in (1, 2, 3, 5, 8, 9):
            J1, J2 = t(rng.standard_normal((B, n1, 2))), t(rng.standard_normal((B, n2, 2)))
            at2, at1 = cuda_kernels.biot_savart_pair(s1, a1, J1, s2, a2, J2, dz2)
            ref2, ref1 = kernels.biot_savart_pair_plain(s1, a1, J1, s2, a2, J2, dz2)
            two2 = cuda_kernels.biot_savart_batch(s1, a1, J1, s2, dz2)
            two1 = cuda_kernels.biot_savart_batch(s2, a2, J2, s1, dz2)
            torch.cuda.synchronize()
            assert at2.shape == (B, n2) and at1.shape == (B, n1)
            assert bool(torch.isfinite(at2).all()) and bool(torch.isfinite(at1).all())
            for out, ref, two in ((at2, ref2, two2), (at1, ref1, two1)):
                assert _rel_err(out, ref) <= TOL[dtype]
                assert _rel_err(out, two) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_q_apply_coincident_points_within_and_across_blocks(cuda, dtype):
    # Evaluation points 0, 128, 256 and 384 are the four points of thread 0
    # of block 0 in float32 (0 and 128 in float64); 600 and 1500 lie in
    # other blocks.  Each coincides with a source, some with two (a
    # duplicated source), in the full tiles and in the ragged last tile.
    rng = np.random.default_rng(5)
    n, m = 1333, 2000
    src = rng.uniform(-5, 5, (n, 2))
    src[1332] = src[7]  # a duplicate in the ragged last tile
    ev = rng.uniform(-4, 4, (m, 2))
    for i, j in ((0, 7), (128, 1331), (256, 200), (384, 201), (600, 7), (1500, 1300)):
        ev[i] = src[j]
    src_t = torch.as_tensor(src, dtype=dtype, device=cuda)
    ev_t = torch.as_tensor(ev, dtype=dtype, device=cuda)
    V = torch.as_tensor(rng.standard_normal((n, 2)), dtype=dtype, device=cuda)
    out = cuda_kernels.q_apply(ev_t, src_t, V)
    ref = kernels.q_apply_plain(ev_t, src_t, V)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _rel_err(out, ref) <= TOL[dtype]
    # A source that coincides with the evaluation point contributes exactly
    # zero: V nonzero only at the coincident source gives a zero row.
    one_hot = torch.zeros((n, 1), dtype=dtype, device=cuda)
    one_hot[1300, 0] = 1.0
    assert float(cuda_kernels.q_apply(ev_t, src_t, one_hot)[1500, 0]) == 0.0


def _deterministic(fn):
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, tuple) else (first,)
    seconds = second if isinstance(second, tuple) else (second,)
    return all(torch.equal(a, b) for a, b in zip(firsts, seconds))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_are_deterministic(cuda, dtype):
    # Fixed-order sums, no atomics: two launches give the same bits.
    rng = np.random.default_rng(9)
    n1, n2 = 3001, 2777

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    s1, s2 = t(rng.uniform(-5, 5, (n1, 2))), t(rng.uniform(-4, 4, (n2, 2)))
    a1, a2 = t(rng.uniform(0.01, 0.02, n1)), t(rng.uniform(0.01, 0.02, n2))
    J1, J2 = t(rng.standard_normal((3, n1, 2))), t(rng.standard_normal((3, n2, 2)))
    V = t(rng.standard_normal((n1, 7)))
    assert _deterministic(lambda: cuda_kernels.q_matrix(s2))
    assert _deterministic(lambda: cuda_kernels.biot_savart_batch(s1, a1, J1, s2, 0.25))
    assert _deterministic(lambda: cuda_kernels.q_apply(s2, s1, V))
    assert _deterministic(lambda: cuda_kernels.biot_savart_pair(s1, a1, J1, s2, a2, J2, 0.25))


def test_biot_savart_pair_same_height_is_finite(cuda):
    # dz2 = 0 between films that do not overlap: masked lanes and ragged
    # tiles must contribute exact zeros, not 0 * inf.
    rng = np.random.default_rng(0)
    s1 = torch.as_tensor(rng.uniform(-1, 1, (130, 2)), device=cuda)
    s2 = torch.as_tensor(rng.uniform(3, 4, (100, 2)), device=cuda)
    at2, at1 = cuda_kernels.biot_savart_pair(
        s1, torch.ones(130, dtype=s1.dtype, device=cuda), torch.rand((2, 130, 2), dtype=s1.dtype, device=cuda),
        s2, torch.ones(100, dtype=s1.dtype, device=cuda), torch.rand((2, 100, 2), dtype=s1.dtype, device=cuda),
        0.0,
    )
    assert bool(torch.isfinite(at2).all()) and bool(torch.isfinite(at1).all())


def test_dispatch_counts_launches(cuda):
    pts = torch.rand((50, 2), device=cuda)
    before = dict(cuda_kernels.LAUNCHES)
    kernels.q_matrix(pts)
    kernels.biot_savart_film_to_film_dz2(pts, torch.ones(50, device=cuda), torch.rand((50, 2), device=cuda), pts + 10, 1.0)
    assert cuda_kernels.LAUNCHES["q_matrix"] == before["q_matrix"] + 1
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before["biot_savart_batch"] + 1
    kernels.q_apply(pts, torch.ones(50, device=cuda))
    assert cuda_kernels.LAUNCHES["q_apply"] == before["q_apply"] + 1


def test_pair_dispatch_follows_the_environment(cuda, monkeypatch):
    pts = torch.rand((50, 2), device=cuda)
    args = (pts, torch.ones(50, device=cuda), torch.rand((1, 50, 2), device=cuda))
    other = (pts + 10, torch.ones(50, device=cuda), torch.rand((1, 50, 2), device=cuda))
    before = dict(cuda_kernels.LAUNCHES)
    two = kernels.biot_savart_pair_dz2(*args, *other, 1.0)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before["biot_savart_batch"] + 2
    monkeypatch.setenv("SUPERSCREEN_TPU_PAIR_COUPLING", "1")
    one = kernels.biot_savart_pair_dz2(*args, *other, 1.0)
    assert cuda_kernels.LAUNCHES["biot_savart_pair"] == before["biot_savart_pair"] + 1
    for a, b in zip(one, two):
        assert _rel_err(a, b) <= TOL[torch.float32]


def test_wrappers_refuse_bad_input(cuda):
    with pytest.raises(ValueError, match="shape"):
        cuda_kernels.q_matrix(torch.zeros((5, 3), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.q_matrix(torch.zeros((2, 5), device=cuda).T)
    with pytest.raises(TypeError):
        cuda_kernels.q_matrix(torch.zeros((5, 2), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        cuda_kernels.q_apply(torch.zeros((5, 2), device=cuda), torch.zeros((4, 2), device=cuda), torch.zeros((5, 1), device=cuda))


@pytest.mark.parametrize("low_memory", [False, True])
def test_solve_on_the_card_matches_cpu_float64(cuda, monkeypatch, low_memory):
    layers = [st.Layer("l0", Lambda=1.0, z0=0), st.Layer("l1", Lambda=0.5, z0=1)]
    films = [
        st.Polygon("big", layer="l0", points=st.geometry.circle(7.5, points=120)),
        st.Polygon("small", layer="l1", points=st.geometry.circle(5, points=100)),
    ]
    holes = [
        st.Polygon("big_hole", layer="l0", points=st.geometry.circle(3.75, points=70)),
        st.Polygon("small_hole", layer="l1", points=st.geometry.circle(2.5, points=60)),
    ]
    device = st.Device("two", layers=layers, films=films, holes=holes)
    device.make_mesh(max_edge_length=0.8)
    if low_memory:
        # Both films take the low-memory path, on the card and on the CPU.
        monkeypatch.setattr(st.solver.utils, "MAX_DENSE_KERNEL_SIZE", 10)
    cpu_device = device.copy()
    cpu_device.solve_dtype = "float64"
    kwargs = dict(
        applied_field=st.sources.ConstantField(1.0),
        circulating_currents={"big_hole": "1 mA"},
        iterations=2,
    )
    gpu = st.solve(device, torch_device="cuda", **kwargs)
    cpu = st.solve(cpu_device, torch_device="cpu", **kwargs)
    for g, c in zip(gpu, cpu):
        for name in device.films:
            a = g.film_solutions[name].stream
            b = c.film_solutions[name].stream
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def _two_films(sites_per_film, solve_dtype):
    layers = [st.Layer("l0", Lambda=1.0, z0=0), st.Layer("l1", Lambda=0.5, z0=1)]
    films = [
        st.Polygon("big", layer="l0", points=st.geometry.circle(7.5, points=120)),
        st.Polygon("small", layer="l1", points=st.geometry.circle(5, points=100)),
    ]
    holes = [
        st.Polygon("big_hole", layer="l0", points=st.geometry.circle(3.75, points=70)),
        st.Polygon("small_hole", layer="l1", points=st.geometry.circle(2.5, points=60)),
    ]
    device = st.Device("two", layers=layers, films=films, holes=holes, solve_dtype=solve_dtype)
    device.make_mesh(min_points=sites_per_film)
    return device


@pytest.mark.parametrize("low_memory", [False, True])
@pytest.mark.parametrize("solve_dtype", ["float32", "float64"])
def test_solve_many_on_the_card_matches_cpu(cuda, monkeypatch, solve_dtype, low_memory):
    """B = 8 on two films of about 2,000 sites: the card (kernels) against
    the CPU (plain versions) at float64, with per-point circulating
    currents and a vortex."""
    device = _two_films(2000, solve_dtype)
    if low_memory:
        monkeypatch.setattr(st.solver.utils, "MAX_DENSE_KERNEL_SIZE", 10)
    cpu_device = device.copy()
    cpu_device.solve_dtype = "float64"
    B = 8
    kwargs = dict(
        applied_fields=[st.sources.ConstantField(v) for v in np.linspace(0.1, 1.0, B)],
        circulating_currents=[{"big_hole": 100.0 * b, "small_hole": -30.0} for b in range(B)],
        vortices=[st.Vortex(x=5.5, y=0.0, film="big")],
        vortex_nPhi0=np.arange(B, dtype=float)[:, None] - 3,
        iterations=3,
    )
    before = dict(cuda_kernels.LAUNCHES)
    gpu = st.solve_many(device, torch_device="cuda", **kwargs)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] - before["biot_savart_batch"] == 6
    cpu = st.solve_many(cpu_device, torch_device="cpu", **kwargs)
    assert len(gpu) == len(cpu) == B
    tol = 1e-4 if solve_dtype == "float32" else 1e-9
    for quantity in ("streams", "current_densities", "self_fields", "other_fields"):
        for name in device.films:
            a, b = getattr(gpu, quantity)[name], getattr(cpu, quantity)[name]
            assert a.dtype == np.dtype(solve_dtype) and a.shape == b.shape
            scale = np.abs(b).max(axis=tuple(range(1, b.ndim)), keepdims=True)
            # Current densities are derivatives of the stream: one more
            # factor of the mesh's inverse edge length in float32.
            factor = 30 if quantity in ("current_densities", "self_fields") else 1
            assert (np.abs(a - b) / scale).max() <= factor * tol, (quantity, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 8])
def test_within_film_field_takes_the_batch_kernel(cuda, dtype, B):
    """The terminal film's self-field on the card is the biot_savart_batch
    kernel with the triangle centroids as sources and dz2 = 0."""
    film = st.Polygon("strip", layer="base", points=st.geometry.box(4, 2, points=120))
    device = st.Device(
        "strip", layers=[st.Layer("base", Lambda=1)], films=[film],
        terminals={"strip": [
            st.Polygon("source", points=st.geometry.box(0.2, 2, center=(-2, 0))),
            st.Polygon("drain", points=st.geometry.box(0.2, 2, center=(2, 0))),
        ]},
    )
    device.make_mesh(min_points=2000)
    mesh = device.meshes["strip"]
    rng = np.random.default_rng(B)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    sites, centroids, areas = t(mesh.sites), t(mesh.triangle_centroids), t(mesh.triangle_areas)
    J = t(rng.standard_normal((B, len(areas), 2)))
    before = cuda_kernels.LAUNCHES["biot_savart_batch"]
    out = kernels.biot_savart_within_film(sites, centroids, areas, J)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 1
    ref = kernels.biot_savart_plain(centroids, areas, J, sites, 0.0)
    assert out.shape == (B, len(mesh.sites)) and bool(torch.isfinite(out).all())
    assert _rel_err(out, ref) <= TOL[dtype]
    cpu = kernels.biot_savart_within_film(*(a.cpu() for a in (sites, centroids, areas, J)))
    assert _rel_err(out.cpu(), cpu) <= TOL[dtype]


def test_transport_sweep_on_the_card_matches_cpu_float64(cuda):
    """A bias sweep of a terminal strip with a hole and a position-dependent
    Lambda, float32 on the card against float64 on the CPU."""

    def weak_spot(x, y, sigma=0.7):
        return 1.0 + 0.5 * np.exp(-(x**2 + (y - 0.3) ** 2) / (2 * sigma**2))

    def build(solve_dtype):
        film = st.Polygon("strip", layer="base", points=st.geometry.box(4, 2, points=160))
        hole = st.Polygon("hole", layer="base", points=st.geometry.circle(0.4, points=32, center=(-0.8, 0)))
        return st.Device(
            "strip", layers=[st.Layer("base", Lambda=st.Parameter(weak_spot))], films=[film],
            holes=[hole], solve_dtype=solve_dtype,
            terminals={"strip": [
                st.Polygon("source", points=st.geometry.box(0.2, 2, center=(-2, 0))),
                st.Polygon("drain", points=st.geometry.box(0.2, 2, center=(2, 0))),
            ]},
        )

    device = build("float32")
    device.make_mesh(min_points=2000)
    cpu_device = build("float64")
    cpu_device.meshes = device.meshes
    B = 4
    kwargs = dict(
        applied_fields=[st.sources.ConstantField(0.05)] * B,
        terminal_currents=[{"strip": {"source": 1.0 + b, "drain": -1.0 - b}} for b in range(B)],
        circulating_currents=[{"hole": 0.5 * b} for b in range(B)],
    )
    gpu = st.solve_many(device, torch_device="cuda", **kwargs)
    cpu = st.solve_many(cpu_device, torch_device="cpu", **kwargs)
    for quantity in ("streams", "self_fields"):
        a, b = getattr(gpu, quantity)["strip"], getattr(cpu, quantity)["strip"]
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), quantity
    assert np.abs(gpu.streams["strip"] - cpu.streams["strip"]).max() <= 1e-4 * np.abs(
        cpu.streams["strip"]
    ).max()


# -- post-processing on the card -----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_field_at_one_height_takes_the_batch_kernel(cuda, dtype):
    """Hz of a sheet at points of one height is one biot_savart_batch
    launch and equals the blocked plain sum on the card; the vector field,
    mixed heights and dz2 = 0 with a point on a sheet position launch none."""
    rng = np.random.default_rng(61)
    n, m = 3001, 1777

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    positions = t(np.column_stack([rng.uniform(-5, 5, (n, 2)), np.full(n, 0.5)]))
    targets = t(np.column_stack([rng.uniform(-6, 6, (m, 2)), np.full(m, 1.25)]))
    J, areas = t(rng.standard_normal((n, 2))), t(rng.uniform(0.01, 0.02, n))
    before = cuda_kernels.LAUNCHES["biot_savart_batch"]
    out = kernels.biot_savart_2d_field(targets, positions, J, areas, vector=False)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 1
    ref = kernels.biot_savart_2d_field_plain(targets, positions, J, areas, vector=False)
    assert out.shape == (m,) and _rel_err(out, ref) <= TOL[dtype]
    vec = kernels.biot_savart_2d_field(targets, positions, J, areas, vector=True)
    assert vec.shape == (m, 3) and _rel_err(vec[:, 2], ref) <= TOL[dtype]
    mixed = targets.clone()
    mixed[::2, 2] += 0.5
    kernels.biot_savart_2d_field(mixed, positions, J, areas, vector=False)
    in_plane = targets.clone()
    in_plane[:, 2] = 0.5
    in_plane[:7, :2] = positions[:7, :2]
    flat = kernels.biot_savart_2d_field(in_plane, positions, J, areas, vector=False)
    assert bool(torch.isfinite(flat).all())
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 1
    cpu = kernels.biot_savart_2d_field(
        *(a.cpu() for a in (in_plane, positions, J, areas)), vector=False
    )
    assert _rel_err(flat.cpu(), cpu) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vector_potential_on_the_card_matches_cpu(cuda, dtype):
    rng = np.random.default_rng(67)
    n, m = 2500, 3000
    arrays = (
        rng.uniform(-6, 6, (m, 2)), rng.uniform(0.5, 2.0, m), rng.uniform(-5, 5, (n, 2)),
        rng.uniform(0.01, 0.02, n), rng.standard_normal((n, 2)),
    )
    xy, z, sites, areas, J = (torch.as_tensor(a, dtype=dtype) for a in arrays)
    cpu = kernels.vector_potential_2d(xy, z, sites, 0.25, areas, J)
    gpu = kernels.vector_potential_2d(
        *(a.to(cuda) for a in (xy, z, sites)), 0.25, areas.to(cuda), J.to(cuda)
    )
    assert gpu.shape == (m, 2) and _rel_err(gpu.cpu(), cpu) <= TOL[dtype]


def test_gather_form_on_the_card_equals_the_scatter_add_and_is_reproducible(cuda):
    from superscreen_tpu_torch.ops import fem

    rng = np.random.default_rng(71)
    n, nnz = 20000, 140000
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    op = fem.COO(rows, cols, vals, (n, n))
    x = torch.as_tensor(rng.standard_normal((n, 8)), device=cuda)
    got = op.matvec(x)
    t_rows, t_cols = torch.as_tensor(rows, device=cuda), torch.as_tensor(cols, device=cuda)
    expected = torch.zeros_like(x).index_add_(
        0, t_rows, torch.as_tensor(vals, device=cuda)[:, None] * x[t_cols]
    )
    assert _rel_err(got, expected) <= 1e-14
    for _ in range(3):
        assert torch.equal(op.matvec(x), got)


def _ring_with_a_weak_spot(sites):
    def weak_spot(x, y, sigma=2.0):
        return 0.5 * (1 + 0.5 * np.exp(-((x + 3) ** 2 + (y - 4) ** 2) / (2 * sigma**2)))

    device = st.Device(
        "ring", layers=[st.Layer("top", Lambda=st.Parameter(weak_spot), z0=1)],
        films=[st.Polygon("ring", layer="top", points=st.geometry.circle(7.0, points=60))],
        holes=[st.Polygon("ring_hole", layer="top", points=st.geometry.circle(3.0, points=30))],
    )
    device.make_mesh(min_points=sites)
    return device


def test_two_bicgstab_runs_are_bitwise_equal(cuda, monkeypatch):
    """The matrix-free BiCGStab route of a low-memory film with an
    inhomogeneous Lambda: two factorizations and sweeps give the same
    iteration count and the same bits (its sparse products are in gather
    form, not atomic scatter-adds)."""
    from superscreen_tpu_torch.ops import linalg

    monkeypatch.setattr(st.solver.utils, "MAX_DENSE_KERNEL_SIZE", 10)
    monkeypatch.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "cg")
    device = _ring_with_a_weak_spot(4000)
    runs = []
    for _ in range(2):
        linalg.CG_STATS.update(solves=0, iterations=0, max_residual=0.0)
        model = st.factorize_model(device=device, current_units="uA", torch_device="cuda")
        assert model.film_data["ring"].fac_kind == "bicgstab"
        result = st.solve_many(
            model=model, applied_fields=[st.sources.ConstantField(v) for v in (0.1, 0.4)],
            circulating_currents=[{"ring_hole": 1.0}, {"ring_hole": -2.0}], torch_device="cuda",
        )
        runs.append((linalg.CG_STATS["iterations"], result.streams["ring"], result.self_fields["ring"]))
    assert runs[0][0] == runs[1][0] > 0
    assert np.array_equal(runs[0][1], runs[1][1]) and np.array_equal(runs[0][2], runs[1][2])


def test_post_processing_on_the_card_matches_cpu(cuda):
    """A float32 solve on the card, post-processed on the card and, from the
    same arrays, on the CPU: interpolation (float64 point location on
    both), a current through a path, fluxoids, field maps and the vector
    potential."""
    device = _two_films(2500, "float32")
    gpu = st.solve(
        device, applied_field=st.sources.ConstantField(0.2),
        circulating_currents={"big_hole": "5 uA"}, iterations=2, torch_device="cuda",
    )[-1]
    assert gpu.torch_device == torch.device("cuda", torch.cuda.current_device())
    cpu = st.Solution(
        device=device, film_solutions=gpu.film_solutions,
        applied_field_func=gpu.applied_field_func, field_units=gpu.field_units,
        current_units=gpu.current_units, circulating_currents=gpu.circulating_currents,
        torch_device="cpu",
    )
    rng = np.random.default_rng(73)
    pts = rng.uniform(-7, 7, (5000, 2))

    def close(a, b, tol):
        a = np.asarray(getattr(a, "magnitude", a), dtype=float)
        b = np.asarray(getattr(b, "magnitude", b), dtype=float)
        return np.abs(a - b).max() <= tol * np.abs(b).max()

    for method in ("linear", "cubic"):
        assert close(gpu.interp_current_density(pts, film="big", method=method),
                     cpu.interp_current_density(pts, film="big", method=method), 1e-6)
        a = gpu.interp_field(pts, film="small", method=method)
        b = cpu.interp_field(pts, film="small", method=method)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert close(np.nan_to_num(a), np.nan_to_num(b), 1e-6)
    path = np.stack([np.linspace(3.8, 7.4, 401), np.zeros(401)], axis=1)
    assert close(gpu.current_through_path(path, film="big"),
                 cpu.current_through_path(path, film="big"), 1e-6)
    for hole in ("big_hole", "small_hole"):
        assert close(sum(gpu.hole_fluxoid(hole)), sum(cpu.hole_fluxoid(hole)), 1e-6)
    before = cuda_kernels.LAUNCHES["biot_savart_batch"]
    field = gpu.field_at_position(pts, zs=2.0)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 2
    assert close(field, cpu.field_at_position(pts, zs=2.0), 1e-5)
    assert close(gpu.screening_field_at_position(pts, zs=2.0, vector=True),
                 cpu.screening_field_at_position(pts, zs=2.0, vector=True), 1e-5)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 2
    assert close(gpu.vector_potential_at_position(pts, zs=2.0),
                 cpu.vector_potential_at_position(pts, zs=2.0), 1e-5)


def test_mutual_inductance_on_the_card_matches_cpu_float64(cuda):
    device = _two_films(2000, "float32")
    cpu_device = device.copy()
    cpu_device.solve_dtype = "float64"
    gpu = device.mutual_inductance_matrix(iterations=3).magnitude
    cpu = cpu_device.mutual_inductance_matrix(iterations=3, torch_device="cpu").magnitude
    assert np.abs(gpu - cpu).max() <= 1e-3 * np.abs(cpu).max()
    solution = st.find_fluxoid_solution(device, {"big_hole": 1}, iterations=3)
    fluxoids = {h: sum(solution.hole_fluxoid(h)).to("Phi_0").magnitude for h in device.holes}
    assert abs(fluxoids["big_hole"] - 1) < 1e-3 and abs(fluxoids["small_hole"]) < 1e-3

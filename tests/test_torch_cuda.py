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


# Rows on both sides of a stream work item (64 rows) and a tensor-core one
# (128), columns on both sides of a stage (32 and 64 columns), and odd row
# lengths, so that no row start but every fourth is 16-byte aligned; and
# rows a multiple of 16 bytes long (n = 128, 1000), whose whole tiles of A
# the stream route copies by cp.async.bulk, 1000 with a cut last tile.
RESIDUAL_EDGES = [
    (1, 1), (31, 127), (64, 128), (129, 129), (257, 1001), (1000, 643), (300, 1000),
]
# Columns of X on both sides of each stream width, the route switches (6
# where rows are not all aligned, 12 where they are) and the tensor-core
# widths (16, 32, 64), and a landscape block.
RESIDUAL_COLUMNS = [1, 2, 3, 5, 6, 8, 9, 11, 12, 16, 17, 33, 64, 100, 2048]
# (X dtype, H dtype or None, R dtype, X given as the transpose of a
# contiguous (k, n)).
RESIDUAL_DTYPES = [
    (torch.float64, torch.float64, torch.float64, False),
    (torch.float64, torch.float32, torch.float64, True),
    (torch.float32, torch.float32, torch.float32, False),
    (torch.float32, None, torch.float64, True),
    (torch.float64, None, torch.float32, False),
]


def _residual_inputs(rng, m, n, k, x_dtype, h_dtype, transposed, cuda):
    A = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=cuda)
    X = torch.as_tensor(rng.standard_normal((k, n) if transposed else (n, k)), dtype=x_dtype,
                        device=cuda)
    X = X.T if transposed else X
    H = None if h_dtype is None else torch.as_tensor(
        rng.standard_normal((m, k)), dtype=h_dtype, device=cuda
    )
    return A, X, H


@pytest.mark.parametrize("dtypes", RESIDUAL_DTYPES)
@pytest.mark.parametrize("k", RESIDUAL_COLUMNS)
@pytest.mark.parametrize("m,n", RESIDUAL_EDGES)
def test_residual_f64_kernel_matches_plain(cuda, m, n, k, dtypes):
    x_dtype, h_dtype, out_dtype, transposed = dtypes
    A, X, H = _residual_inputs(np.random.default_rng(1000 * m + k), m, n, k, x_dtype, h_dtype,
                               transposed, cuda)
    before = cuda_kernels.LAUNCHES["residual_f64"]
    out = kernels.residual_f64(A, X, H, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["residual_f64"] == before + 1
    assert out.shape == (m, k) and out.dtype == out_dtype
    exact = kernels.residual_f64(A, X, H)
    # The float32 result is the float64 sum rounded once.
    assert torch.equal(out, exact.to(out_dtype))
    # float64 sums of exact products in another order.
    assert _rel_err(exact, kernels.residual_f64_plain(A, X, H)) <= TOL[torch.float64]
    assert torch.equal(out, kernels.residual_f64(A, X, H, out_dtype=out_dtype))


@pytest.mark.parametrize("route", ["stream", "mma"])
@pytest.mark.parametrize("n,k", [(2050, 1), (2050, 3), (2050, 5), (2048, 1), (2048, 5),
                                 (2048, 8), (2048, 11)])
def test_residual_f64_routes_match_plain(cuda, monkeypatch, route, k, n):
    """Both routes at the widths where either may be chosen (the plan
    replaced by the other route's), on a rectangular block whose rows are
    8 mod 16 bytes apart (the stream route's windows, k <= 5) or aligned
    (its TMA, k <= 11)."""
    m = 700
    A, X, H = _residual_inputs(np.random.default_rng(k), m, n, k, torch.float64, torch.float64,
                               False, cuda)
    monkeypatch.setattr(cuda_kernels, "residual_plan",
                        lambda m, n, k, sms=132, aligned=False: cuda_kernels._route_plan(
                            m, n, k, sms, route))
    out = cuda_kernels.residual_f64(A, X, H)
    assert _rel_err(out, kernels.residual_f64_plain(A, X, H)) <= TOL[torch.float64]
    assert torch.equal(out, cuda_kernels.residual_f64(A, X, H))


@pytest.mark.parametrize("n", [201, 200])
@pytest.mark.parametrize("k", [3, 64])
def test_residual_f64_takes_a_row_block_and_refuses_bad_input(cuda, k, n):
    rng = np.random.default_rng(5)
    # n = 201: rows start 4 bytes apart mod 16, and the views below start
    # at every alignment.  n = 200: every row of A is aligned (the stream
    # route's cp.async.bulk), and the copies of A below start 0-3 floats
    # past a 16-byte boundary (its windows).
    A = torch.as_tensor(rng.standard_normal((300, n)), dtype=torch.float32, device=cuda)
    X = torch.as_tensor(rng.standard_normal((n, k)), device=cuda)
    H = torch.zeros((300, k), dtype=torch.float64, device=cuda)
    full = kernels.residual_f64(A, X, H)
    for lo in (40, 41, 42, 43):
        rows = kernels.residual_f64(A[lo:170], X, H[lo:170])
        assert torch.equal(rows, full[lo:170])
        exact = kernels.residual_f64_plain(A[lo:170], X, H[lo:170])
        assert _rel_err(rows, exact) <= TOL[torch.float64]
    flat = torch.empty(A.numel() + 3, dtype=torch.float32, device=cuda)
    for offset in (0, 1, 2, 3):
        moved = flat[offset:offset + A.numel()].view(A.shape)
        moved.copy_(A)
        assert torch.equal(kernels.residual_f64(moved, X, H), full)
    with pytest.raises(TypeError):
        cuda_kernels.residual_f64(A.double(), X, H)
    with pytest.raises(TypeError):
        cuda_kernels.residual_f64(A, X.half(), H)
    with pytest.raises(TypeError):
        cuda_kernels.residual_f64(A, X, H, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        cuda_kernels.residual_f64(A, X[:-1], H)
    with pytest.raises(ValueError):  # neither X nor X.T contiguous
        cuda_kernels.residual_f64(A, torch.zeros_like(X).repeat(1, 2)[:, ::2], H)
    with pytest.raises(ValueError):
        cuda_kernels.residual_f64(A.cpu(), X, H)


def test_residual_f64_callers_launch_only_the_kernel(cuda):
    """``system_residual`` and the sweep's dense self-field pass their
    tensors as they are: the card runs residual_f64's kernels and nothing
    else (no casts, no zeros, no copies)."""
    from types import SimpleNamespace

    from superscreen_tpu_torch import sweep
    from superscreen_tpu_torch.ops import linalg

    rng = np.random.default_rng(8)
    n, B = 3001, 6
    A = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=cuda)
    x = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32, device=cuda).T
    h = torch.as_tensor(rng.standard_normal((n, B)), dtype=torch.float32, device=cuda)
    weights = torch.ones(n, dtype=torch.float32, device=cuda)
    data = SimpleNamespace(weights=weights, terminal=False, brandt_diag=None, Qw=A)
    g = x.T
    calls = {
        "system_residual": lambda: linalg.system_residual(A, h, x),
        "_self_field_batch": lambda: sweep._self_field_batch(data, g),
    }
    for label, call in calls.items():
        call()
        torch.cuda.synchronize()
        before = cuda_kernels.LAUNCHES["residual_f64"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert cuda_kernels.LAUNCHES["residual_f64"] == before + 1, label
        assert names and all("residual" in name for name in names), (label, names)
        assert out.dtype == torch.float32, label


def test_system_residual_on_the_card_is_float64_from_one_column(cuda):
    from superscreen_tpu_torch.ops import linalg

    rng = np.random.default_rng(6)
    n = 2000
    A64 = torch.as_tensor(rng.standard_normal((n, n)) + 50 * np.eye(n), device=cuda)
    x64 = torch.as_tensor(rng.uniform(0.5, 1.5, (n, 1)), device=cuda)
    h64 = -(A64 @ x64) * (1 + 1e-4 * torch.as_tensor(rng.standard_normal((n, 1)), device=cuda))
    A, h, x = A64.float(), h64.float(), x64.float()
    exact = h.double() + A.double() @ x.double()
    before = cuda_kernels.LAUNCHES["residual_f64"]
    r = linalg.system_residual(A, h, x)
    assert cuda_kernels.LAUNCHES["residual_f64"] == before + 1 and r.dtype == torch.float32
    err = _rel_err(r.double(), exact)
    assert err <= 1e-6 and err < _rel_err((h + A @ x).double(), exact)


def test_high_precision_and_polish_on_the_card_match_float64(cuda):
    device = _two_films(700, "float32")
    device64 = device.copy()
    device64.solve_dtype = "float64"
    kwargs = dict(
        applied_field=st.sources.ConstantField(1.0), circulating_currents={"big_hole": "1 mA"},
        iterations=3,
    )
    exact = st.solve(device64, torch_device="cuda", **kwargs)[-1]
    hp = st.solve(device, high_precision=True, check_inversion=True, torch_device="cuda", **kwargs)[-1]
    polished = st.solve_many(
        device, applied_fields=[kwargs["applied_field"]],
        circulating_currents=[kwargs["circulating_currents"]], iterations=3, final_refine=2,
        torch_device="cuda",
    )
    assert polished.final_refine_report["residual_rel_max_after"] < 1e-9
    for name, fs in exact.film_solutions.items():
        scale = np.abs(fs.stream).max()
        assert np.abs(hp.film_solutions[name].stream - fs.stream).max() <= 1e-9 * scale
        # The polish solves the float32-rounded system exactly.
        assert np.abs(polished.streams[name][0] - fs.stream).max() <= 1e-5 * scale


def test_fft_coupling_round_on_the_card_matches_cpu(cuda):
    """One FFT coupling round (cuFFT, gathers, the transfer) on the card
    against the same round on the CPU, float32."""
    from types import SimpleNamespace

    from superscreen_tpu_torch.ops import fft_coupling
    from superscreen_tpu_torch.sweep import _coupling_round

    device = _two_films(1500, "float32")
    films = list(device.films)
    z0 = {name: float(device.layers[device.films[name].layer].z0) for name in films}
    rng = np.random.default_rng(8)
    g = {name: rng.standard_normal((4, len(device.meshes[name].sites))) for name in films}
    out = {}
    for where in ("cpu", "cuda"):
        grids = fft_coupling.build_film_grid_data(device, where)
        data = {name: SimpleNamespace(fft_grid=grids[name], z0=z0[name]) for name in films}
        streams = {name: torch.as_tensor(g[name], dtype=torch.float32, device=where) for name in films}
        out[where] = _coupling_round(data, films, streams, None, None, "fft")
    for name in films:
        assert out["cuda"][name].device.type == "cuda"
        assert _rel_err(out["cuda"][name].cpu(), out["cpu"][name]) <= TOL[torch.float32]


def test_solve_many_fft_on_the_card_matches_cpu(cuda):
    device = _two_films(1500, "float32")
    kwargs = dict(
        applied_fields=[st.sources.ConstantField(v) for v in (0.5, 1.0)], iterations=3,
        coupling="fft",
    )
    card = st.solve_many(device, torch_device="cuda", **kwargs)
    cpu = st.solve_many(device, torch_device="cpu", **kwargs)
    for name, a in cpu.streams.items():
        assert np.abs(card.streams[name] - a).max() <= 1e-4 * np.abs(a).max()


def _mini_squid(sites):
    squid = st.Device(
        "mini_squid",
        layers=[st.Layer("sq", Lambda=0.3, z0=0)],
        films=[st.Polygon("fc_ring", layer="sq", points=st.geometry.circle(1.5, points=80))],
        holes=[st.Polygon("fc_hole", layer="sq", points=st.geometry.circle(0.9, points=50))],
        abstract_regions=[st.Polygon("pl", layer="sq", points=st.geometry.circle(0.4, points=48))],
        length_units="um",
    )
    squid.make_mesh(min_points=sites, smooth=5)
    sample = st.Device(
        "sample",
        layers=[st.Layer("s", Lambda=0.1, z0=0)],
        films=[st.Polygon("disk", layer="s", points=st.geometry.circle(6.0, points=160))],
        length_units="um",
    )
    sample.make_mesh(min_points=4 * sites, smooth=5)
    return squid, sample


def test_applied_field_maps_per_position_match_scalar_height_launches(cuda):
    """Per-position heights (one biot_savart_batch launch per position)
    against the scalar-height launch over all positions at once."""
    from superscreen_tpu_torch.squids import scanning

    squid, sample = _mini_squid(500)
    solution = st.solve(squid, circulating_currents={"fc_hole": "1 mA"}, current_units="mA",
                        torch_device="cuda")[-1]
    B = 6
    positions = np.column_stack([np.linspace(-8, 8, B), np.zeros(B)])
    kw = dict(current_units="uA", torch_device="cuda")
    before = cuda_kernels.LAUNCHES["biot_savart_batch"]
    scalar = scanning.applied_field_maps(sample, solution, positions, squid_height=1.0, **kw)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 1
    per = scanning.applied_field_maps(sample, solution, positions, squid_height=np.ones(B), **kw)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 1 + B
    cpu = scanning.applied_field_maps(sample, solution, positions, squid_height=1.0,
                                      current_units="uA", torch_device="cpu")
    for name, H in scalar.items():
        assert H.device.type == "cuda"
        assert _rel_err(per[name], H) <= TOL[torch.float32]
        assert _rel_err(H.cpu(), cpu[name]) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dz2", [0.0, 0.25])
@pytest.mark.parametrize("B", [1, 3, 8, 9])
def test_coupling_vjp_on_the_kernel_matches_plain_autograd(cuda, dtype, dz2, B):
    """``BiotSavartCoupling``'s backward pass (one biot_savart_batch launch
    of 2B columns, roles swapped) against autograd through the plain sum."""
    from superscreen_tpu_torch.ops import autograd

    rng = np.random.default_rng(100 * B + int(4 * dz2))
    n1, n2 = 3001, 1777
    src = torch.as_tensor(rng.uniform(-5, 5, (n1, 2)), dtype=dtype, device=cuda)
    dst = torch.as_tensor(rng.uniform(-4, 4, (n2, 2)), dtype=dtype, device=cuda)
    areas = torch.as_tensor(rng.uniform(0.01, 0.02, n1), dtype=dtype, device=cuda)
    J = torch.as_tensor(rng.standard_normal((B, n1, 2)), dtype=dtype, device=cuda).requires_grad_()
    g = torch.as_tensor(rng.standard_normal((B, n2)), dtype=dtype, device=cuda)
    before = cuda_kernels.LAUNCHES["biot_savart_batch"]
    out = autograd.BiotSavartCoupling.apply(J, src, areas, dst, dz2)
    (vjp,) = torch.autograd.grad(out, J, g)
    assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 2
    (plain,) = torch.autograd.grad(kernels.biot_savart_plain(src, areas, J, dst, dz2), J, g)
    torch.cuda.synchronize()
    assert vjp.shape == J.shape
    assert _rel_err(vjp, plain) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adjoint_backward_on_the_card_is_reproducible_and_matches_cpu(cuda, dtype):
    """A coupled two-film forward pass and its backward pass on the card:
    two backward passes give the same bits (gather-form transposes, no
    atomics), the backward pass launches the kernel, and the gradient
    matches the float64 CPU model's (float32: within 1e-3)."""
    device = _two_films(1500, dtype)
    cpu_device = device.copy()
    cpu_device.solve_dtype = "float64"
    grads = []
    for dev, where in ((device, "cuda"), (device, "cuda"), (cpu_device, "cpu")):
        model = st.build_adjoint_model(dev, current_units="mA", torch_device=where)
        params = model.default_params(applied_field=st.sources.ConstantField(0.5))
        params["circulating_currents"]["big_hole"] = torch.tensor(1.0, dtype=model.dtype, device=where)
        lam = params["Lambda"]["small"].clone().requires_grad_()
        out = model.forward_fn(2)({**params, "Lambda": {**params["Lambda"], "small": lam}})
        loss = torch.sum(out["big"]["self_field"] ** 2) + torch.sum(out["small"]["stream"] ** 2)
        before = dict(cuda_kernels.LAUNCHES)
        (grad,) = torch.autograd.grad(loss, lam)
        if where == "cuda":
            # Two rounds, two passes each; the first round's pass from the
            # big film carries no gradient.
            assert cuda_kernels.LAUNCHES["biot_savart_batch"] == before["biot_savart_batch"] + 3
        grads.append(grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert _rel_err(grads[0].double(), grads[2]) <= (1e-3 if dtype == "float32" else 1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_public_q_matrix_and_mesh_operators_run_the_kernel(cuda, dtype):
    """``distance.q_matrix`` and ``MeshOperators.Q_matrix`` on the card are
    the ``q_matrix`` kernel's route, bit for bit, and within 1e-6 of the
    plain versions."""
    device = _two_films(3000, "float32")
    mesh = device.meshes["big"]
    sites = torch.as_tensor(mesh.sites.astype(dtype), device=cuda)
    weights = torch.as_tensor(mesh.vertex_areas.astype(dtype), device=cuda)
    before = cuda_kernels.LAUNCHES["q_matrix"]
    q = st.distance.q_matrix(mesh.sites, dtype=dtype, torch_device="cuda")
    assert cuda_kernels.LAUNCHES["q_matrix"] == before + 1
    assert q.dtype == dtype
    assert np.array_equal(q, kernels.q_matrix(sites).cpu().numpy())
    assert _rel_err(torch.from_numpy(q), kernels.q_matrix_plain(sites.cpu())) <= 1e-6
    Q = st.MeshOperators.Q_matrix(mesh.sites.astype(dtype), mesh.vertex_areas.astype(dtype))
    assert np.array_equal(Q, kernels.Q_matrix(sites, weights).cpu().numpy())
    plain = kernels.Q_matrix(sites.cpu(), weights.cpu())
    assert _rel_err(torch.from_numpy(Q), plain) <= 1e-6


def test_translate_and_mirror_on_the_card(cuda, tmp_path, monkeypatch):
    """The float32 streams of a translated device (which keeps its mesh)
    within 1e-4 of the original's; a mirrored device meshed through the
    mesh cache (a hit) within 1e-6: the coupling depends on dz^2 only."""
    monkeypatch.setenv("SUPERSCREEN_TPU_MESH_CACHE", str(tmp_path))
    device = _two_films(3000, "float32")
    kwargs = dict(applied_field=st.sources.ConstantField(0.5),
                  circulating_currents={"big_hole": "2 uA"}, iterations=3, coupling="exact",
                  progress_bar=False)
    ref = st.solve(device, **kwargs)[-1]

    def err(solution):
        return max(
            float(np.abs(solution.film_solutions[k].stream - fs.stream).max()
                  / np.abs(fs.stream).max())
            for k, fs in ref.film_solutions.items()
        )

    assert err(st.solve(device.translate(3.0, -2.0), **kwargs)[-1]) <= 1e-4
    entries = sorted(tmp_path.iterdir())
    assert len(entries) == 2
    mirrored = device.mirror_layers()
    mirrored.make_mesh(min_points=3000)
    assert sorted(tmp_path.iterdir()) == entries
    for name, mesh in device.meshes.items():
        assert np.array_equal(mirrored.meshes[name].sites, mesh.sites)
    assert err(st.solve(mirrored, **kwargs)[-1]) <= 1e-6


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_public_cdist_and_C_vector_compute_on_the_card(cuda, dtype):
    """``distance.cdist`` and ``MeshOperators.C_vector`` compute on the card
    by default (NumPy in and out) and agree with their CPU results (1e-12
    in float64, 1e-6 in float32, relative to the largest distance and to
    each entry of C)."""
    tol = 1e-6 if dtype == np.float32 else 1e-12
    rng = np.random.default_rng(5)
    for dim in (2, 3):
        XA, XB = rng.normal(size=(700, dim)).astype(dtype), rng.normal(size=(300, dim)).astype(dtype)
        for metric in ("euclidean", "sqeuclidean"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got = st.distance.cdist(XA, XB, metric=metric)
            assert torch.cuda.max_memory_allocated() >= got.nbytes
            want = st.distance.cdist(XA, XB, metric=metric, torch_device="cpu")
            assert got.dtype == want.dtype == dtype
            assert np.abs(got - want).max() <= tol * np.abs(want).max()
    # C diverges where x - mean(x) = +-a, at sites that a rounding of the
    # centroid moves, so the points lie on a dyadic grid and number 2^12:
    # the centroid is then exact in any summation order, and C is held
    # entry by entry.
    sites = (rng.integers(-400, 400, (4096, 2)) / 8).astype(dtype)
    got = st.MeshOperators.C_vector(sites)
    want = st.MeshOperators.C_vector(sites, torch_device="cpu")
    assert got.dtype == want.dtype == dtype
    assert np.all(np.abs(got - want) <= tol * np.abs(want))


@pytest.mark.parametrize("low_memory", [False, True])
def test_native_core_builds_and_solve_film_matches_cpu(cuda, monkeypatch, low_memory):
    """The geometry core builds with the host compiler of the card's
    machine and decides points as its NumPy twin does; ``solve_film`` on a
    film of about 2,000 sites with a hole current and a vortex runs on the
    card (the refinement through residual_f64; the self-field through
    q_apply on the low-memory path) and matches the same call on the CPU
    (float32, 1e-5 of max|g|)."""
    import importlib

    from superscreen_tpu_torch import native
    from superscreen_tpu_torch.device.polygon import points_in_ring_plain
    from superscreen_tpu_torch.solver.utils import field_conversion_factor, make_film_info

    solve_film = importlib.import_module("superscreen_tpu_torch.solver.solve_film")
    assert native.available()
    rng = np.random.default_rng(11)
    ring = st.geometry.close_curve(st.geometry.circle(3, points=500))
    queries = np.concatenate([rng.uniform(-3.5, 3.5, (20000, 2)), ring])
    assert np.array_equal(native.points_in_ring(ring, queries), points_in_ring_plain(ring, queries))
    if low_memory:
        monkeypatch.setattr(st.solver.utils, "MAX_DENSE_KERNEL_SIZE", 10)
    device = _two_films(2000, "float32")
    conv = field_conversion_factor("mT", "uA", length_units="um").magnitude
    n = len(device.meshes["big"].sites)
    applied = conv * (0.5 + 0.1 * rng.standard_normal(n))
    others = conv * 0.05 * rng.standard_normal(n)
    solutions = {}
    for where in ("cuda", "cpu"):
        info = make_film_info(
            device=device, circulating_currents={"big_hole": 2.0},
            vortices=[st.Vortex(x=5.0, y=0.5, film="big")], films=["big"], torch_device=where,
        )
        films, holes, terminals = solve_film.factorize_linear_systems(device, info)
        before = dict(cuda_kernels.LAUNCHES)
        solutions[where] = solve_film.solve_film(
            device=device, applied_field=applied, film_info=info["big"],
            film_system=films["big"], hole_systems=holes["big"], field_conversion=conv,
            vortex_flux=float(st.ureg("Phi_0 / mu_0").to("uA * um").magnitude),
            field_from_other_films=others,
        )
        if where == "cuda":
            assert cuda_kernels.LAUNCHES["residual_f64"] > before["residual_f64"]
            if low_memory:
                assert cuda_kernels.LAUNCHES["q_apply"] > before["q_apply"]
    for quantity in ("stream", "current_density", "self_field"):
        got, want = (getattr(solutions[w], quantity) for w in ("cuda", "cpu"))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), quantity


# -- the multi-device layer (superscreen_tpu_torch.parallel) ------------------


def _mesh_devices(k):
    """``k`` slots: ``cuda:0`` repeated, and the cards in turn where there
    are several."""
    count = torch.cuda.device_count()
    layouts = [["cuda:0"] * k]
    if count > 1:
        layouts.append([f"cuda:{i % count}" for i in range(k)])
    return layouts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n_dst", [(5, 1001), (1, 777), (6, 1)], ids=["ragged", "empty-data-row", "empty-slot"])
def test_sharded_coupling_and_self_field_on_the_card(cuda, dtype, B, n_dst):
    """The sharded coupling and self-field on a 2 x 2 mesh at ragged shapes
    (B and n not divisible; a data row or a model slot holding only
    padding, which launches nothing) against the unsharded kernels, one
    launch per non-empty block."""
    from superscreen_tpu_torch import parallel

    rng = np.random.default_rng(B + n_dst)
    n_src = 1203
    t = dict(dtype=dtype, device=cuda)
    src = torch.as_tensor(rng.uniform(-5, 5, (n_src, 2)), **t)
    dst = torch.as_tensor(rng.uniform(-5, 5, (n_dst, 2)), **t)
    areas = torch.as_tensor(rng.uniform(0.01, 0.02, n_src), **t)
    J = torch.as_tensor(rng.standard_normal((B, n_src, 2)), **t)
    g = torch.as_tensor(rng.standard_normal((B, n_src)), **t)
    blocks = sum(d * (-(-B // 2)) < B for d in range(2)) * sum(m * (-(-n_dst // 2)) < n_dst for m in range(2))
    ref = kernels.biot_savart_film_to_film_dz2(src, areas, J, dst, 0.3)
    sf_ref = kernels.Q_apply(src, areas, (areas[None, :] * g).T).T
    # The self-field cancels to a small part of its terms: held relative
    # to the kernel's own output, q (w g).
    scale = float(kernels.q_apply(src, (areas[None, :] * g).T).abs().max())
    for devices in _mesh_devices(4):
        mesh = parallel.make_mesh(n_data=2, n_model=2, devices=devices)
        before = dict(cuda_kernels.LAUNCHES)
        out = parallel.sharded_biot_savart(mesh, src, areas, J, dst, 0.3)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES["biot_savart_batch"] - before["biot_savart_batch"] == blocks
        assert out.shape == (B, n_dst) and _rel_err(out, ref) <= TOL[dtype]
        diag = parallel.self_field_diagonal(mesh, src, areas)
        before = dict(cuda_kernels.LAUNCHES)
        sf = parallel.sharded_self_field(mesh, src, areas, g, diag=diag)
        torch.cuda.synchronize()
        sf_blocks = sum(d * (-(-B // 2)) < B for d in range(2)) * 2
        assert cuda_kernels.LAUNCHES["q_apply"] - before["q_apply"] == sf_blocks
        assert float((sf - sf_ref).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("n,parts", [(1000, 2), (1002, 2), (1001, 3)], ids=["aligned", "rows-8-bytes-off", "ragged"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_row_sharded_residual_f64_on_the_card(cuda, n, parts, k):
    """RowSharded.residual_f64 on aligned and unaligned row blocks (each
    block a view of the matrix) against the plain version, one launch per
    block."""
    from superscreen_tpu_torch.ops.rows import RowSharded

    rng = np.random.default_rng(n + k)
    A = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=cuda)
    X = torch.as_tensor(rng.standard_normal((n, k)), dtype=torch.float64, device=cuda)
    H = torch.as_tensor(rng.standard_normal((n, k)), dtype=torch.float64, device=cuda)
    ref = kernels.residual_f64_plain(A, X, H)
    for devices in _mesh_devices(parts):
        rows = RowSharded.split(A, devices)
        if devices[0] == devices[-1]:
            assert all(b.data_ptr() == A[lo:].data_ptr() for b, (lo, _) in zip(rows.blocks, rows.bounds))
        before = cuda_kernels.LAUNCHES["residual_f64"]
        out = rows.residual_f64(X, H)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES["residual_f64"] - before == parts
        assert _rel_err(out, ref) <= TOL[torch.float64]
        assert torch.equal(rows.residual_f64(X, H, out_dtype=torch.float32), out.to(torch.float32))


@pytest.mark.parametrize("method", ["schur", "schulz"])
def test_sharded_spd_inverse_on_the_card(cuda, method):
    """The row-sharded explicit inverse in float64 against torch.linalg.inv,
    with several pivot panels per slot."""
    from superscreen_tpu_torch import parallel
    from superscreen_tpu_torch.ops import rows

    rng = np.random.default_rng(4)
    n = 600
    G = rng.standard_normal((n, n))
    w = 0.5 + rng.random(n)
    neg_A = torch.as_tensor(-((G @ G.T / n + 3.0 * np.eye(n)) * w[None, :]), device=cuda)
    ref = torch.linalg.inv(neg_A)
    for devices in _mesh_devices(2):
        mesh = parallel.make_mesh(n_data=1, n_model=2, devices=devices)
        if method == "schur":
            M = rows.schur_inverse_rows(rows.RowSharded.split(neg_A, devices),
                                        torch.as_tensor(w, device=cuda), sign=-1.0, leaf=128)
        else:
            M = parallel.sharded_spd_inverse(mesh, neg_A, torch.as_tensor(w, device=cuda), method)
        assert [b.device for b in M.blocks] == [torch.device(d) for d in devices]
        assert _rel_err(M.to_dense(cuda), ref) <= 1e-9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r0,r1", [(0, 1000), (256, 700), (3, 517), (999, 1001)], ids=["all", "aligned", "unaligned", "tail"])
def test_q_matrix_rect_on_the_card(cuda, dtype, r0, r1):
    """The rectangular entry of the q_matrix kernel: rows r0:r1 of the
    square matrix, diagonal zero, one launch."""
    rng = np.random.default_rng(r0)
    pts = torch.as_tensor(rng.uniform(-5, 5, (1001, 2)), dtype=dtype, device=cuda)
    before = cuda_kernels.LAUNCHES["q_matrix"]
    out = cuda_kernels.q_matrix_rect(pts[r0:r1], pts)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["q_matrix"] == before + 1
    ref = kernels.q_matrix_plain(pts)[r0:r1]
    assert out.shape == ref.shape and bool((out[:, r0:r1].diagonal() == 0).all())
    assert _rel_err(out, ref) <= TOL[dtype]
    assert torch.equal(out, cuda_kernels.q_matrix(pts)[r0:r1])


def _spd_system(n, dtype, device, seed=5):
    """A system of the Brandt form ``A = P diag(w)`` with ``P`` symmetric
    positive definite."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    P = G @ G.T / n + 3.0 * np.eye(n)
    w = rng.uniform(0.5, 1.5, n)
    A = torch.as_tensor(P * w[None, :], dtype=dtype, device=device)
    return A, torch.as_tensor(w, dtype=dtype, device=device), rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ["inv", "chol", "schur", "schulz", "cg"])
def test_factor_routes_on_the_card_match_lu(cuda, monkeypatch, dtype, route):
    """Each large-film route at 4,096 unknowns on the card (LU_MAX_N_TPU
    lowered below it), its refined solves against the LU's: the tag, the
    factor's device, and the streams within the float32 or float64 class.
    ``"cg"`` on a system that is materialized anyway takes ``"schur"``."""
    from superscreen_tpu_torch.ops import linalg

    n = 4096
    A, w, rng = _spd_system(n, dtype, cuda)
    h = torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype, device=cuda)
    ref = linalg.lu_solve_refined(A, linalg.factor_system(A), h)
    monkeypatch.setattr(linalg, "LU_MAX_N_TPU", 4000)
    monkeypatch.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", route)
    factors = linalg.factor_system(A, w)
    assert factors[0] == ("chol" if route == "chol" else "inv")
    assert factors[1].device.type == "cuda" and factors[1].shape == (n, n)
    x = linalg.lu_solve_refined(A, factors, h)
    torch.cuda.synchronize()
    assert _rel_err(x, ref) <= (1e-5 if dtype == torch.float32 else 1e-11)


def test_factor_system_takes_the_default_route_on_the_card_only(cuda, monkeypatch):
    """Above LU_MAX_N_TPU a system on the card takes "inv" by default and
    the same system on the CPU takes LU; without weights (an inhomogeneous
    Lambda) the card inverts it from its LU, and the CPU takes LU."""
    from superscreen_tpu_torch.ops import linalg

    monkeypatch.delenv("SUPERSCREEN_TPU_LARGE_FACTOR", raising=False)
    monkeypatch.setattr(linalg, "LU_MAX_N_TPU", 1000)
    A, w, _ = _spd_system(1100, torch.float32, cuda)
    assert linalg.factor_kind(linalg.factor_system(A, w)) == "inv"
    assert linalg.factor_kind(linalg.factor_system(A.cpu(), w.cpu())) == "lu"
    kind, M, none = linalg.factor_system(A)
    assert kind == "inv" and none is None and M.is_cuda and M.is_contiguous()
    assert linalg.factor_kind(linalg.factor_system(A.cpu())) == "lu"


def test_inhomogeneous_film_inverted_from_lu_on_the_card_matches_lu(cuda, monkeypatch):
    """A film of ~4,000 unknowns with a weak spot in Lambda (no symmetric
    scaling) at float32 on the card, inverted from its LU above
    LU_MAX_N_TPU: its solves after two refinement steps against the LU
    route's, and a bias sweep through each route."""
    from superscreen_tpu_torch.ops import linalg

    def weak_spot(x, y, sigma=0.7):
        return 1.0 + 0.5 * np.exp(-(x**2 + (y - 0.3) ** 2) / (2 * sigma**2))

    device = st.Device(
        "strip", layers=[st.Layer("base", Lambda=st.Parameter(weak_spot))],
        films=[st.Polygon("strip", layer="base", points=st.geometry.box(4, 2, points=200))],
        solve_dtype="float32",
        terminals={"strip": [
            st.Polygon("source", points=st.geometry.box(0.2, 2, center=(-2, 0))),
            st.Polygon("drain", points=st.geometry.box(0.2, 2, center=(2, 0))),
        ]},
    )
    device.make_mesh(min_points=4400)
    models = {}
    for route, limit in (("lu", linalg.LU_MAX_N_TPU), ("inv", 1000)):
        monkeypatch.setattr(linalg, "LU_MAX_N_TPU", limit)
        models[route] = st.factorize_model(device=device, current_units="uA", torch_device="cuda")
        assert models[route].film_data["strip"].fac_kind == route
    system = models["inv"].film_systems["strip"]
    n = len(system.indices)
    assert 3500 < n < 5000 and system.lu_piv[2] is None and system.lu_piv[1].shape == (n, n)
    h = torch.as_tensor(np.random.default_rng(2).standard_normal((n, 3)), dtype=torch.float32, device=cuda)
    x = linalg.lu_solve_refined(system.A, system.lu_piv, h)
    ref = linalg.lu_solve_refined(system.A, models["lu"].film_systems["strip"].lu_piv, h)
    torch.cuda.synchronize()
    assert _rel_err(x, ref) <= 1e-5
    kwargs = dict(
        applied_fields=[st.sources.ConstantField(0.05)] * 4,
        terminal_currents=[{"strip": {"source": 1.0 + b, "drain": -1.0 - b}} for b in range(4)],
        torch_device="cuda",
    )
    streams = {route: st.solve_many(model=model, **kwargs).streams["strip"] for route, model in models.items()}
    assert np.abs(streams["inv"] - streams["lu"]).max() <= 1e-5 * np.abs(streams["lu"]).max()

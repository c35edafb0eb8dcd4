"""The port's pairwise kernels against the JAX package's.

The port's plain PyTorch versions (the path a CPU tensor takes) are held
against the Pallas TPU kernels run in interpret mode (float32, small
tiles as in ``tests/test_pallas.py``) and against the JAX package's
blocked jnp kernels (float64).  Inputs come from a NumPy seed.
"""

import numpy as np
import pytest
import torch

from superscreen_tpu.ops import kernels as jkernels
from superscreen_tpu.ops.pallas_kernels import (
    PALLAS_AVAILABLE,
    pallas_biot_savart_batch,
    pallas_biot_savart_pair,
    pallas_q_apply_rect,
    pallas_q_matrix,
)
from superscreen_tpu_torch.ops import cuda_kernels, kernels

torch.set_num_threads(2)

needs_pallas = pytest.mark.skipif(not PALLAS_AVAILABLE, reason="Pallas is not importable")

# Small tiles so interpret mode covers multi-tile grids (tests/test_pallas.py).
TM, TN = 16, 128


def _sites(rng, n, scale=3.0):
    return rng.uniform(-scale, scale, size=(n, 2))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _bs_inputs(seed, B, n1, n2):
    rng = np.random.default_rng(seed)
    src = _sites(rng, n1)
    dst = _sites(rng, n2) + 0.5
    areas = rng.uniform(0.01, 0.05, size=n1)
    J = rng.standard_normal((B, n1, 2))
    return src, areas, J, dst


@needs_pallas
@pytest.mark.parametrize("n", [128, 129, 200])
def test_q_matrix_matches_pallas_interpret(n):
    # float32 on both sides: rsqrt rounding differs by a few ulp, so 1e-5
    # relative to the largest entry.
    pts = _sites(np.random.default_rng(n), n).astype(np.float32)
    ref = np.asarray(pallas_q_matrix(pts, tm=8, tn=128, interpret=True))
    out = kernels.q_matrix(_t(pts, torch.float32)).numpy()
    assert out.shape == (n, n)
    assert np.all(np.diag(out) == 0)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n", [97, 300])
def test_q_matrix_matches_jnp_float64(n):
    pts = _sites(np.random.default_rng(10 + n), n)
    ref = np.asarray(jkernels._q_matrix_jnp(pts, block=64))
    out = kernels.q_matrix(_t(pts)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=0)


def test_q_matrix_coincident_points_are_zero():
    pts = _sites(np.random.default_rng(3), 64)
    pts[10] = pts[40]
    q = kernels.q_matrix(_t(pts)).numpy()
    assert np.isfinite(q).all()
    assert q[10, 40] == 0.0 and q[40, 10] == 0.0


@pytest.mark.parametrize("n", [50, 211])
def test_Q_matrix_matches_jax(n):
    rng = np.random.default_rng(20 + n)
    pts = _sites(rng, n)
    w = rng.uniform(0.01, 0.05, size=n)
    ref = np.asarray(jkernels.Q_matrix(pts, w))
    out = kernels.Q_matrix(_t(pts), _t(w)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@needs_pallas
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("n1,n2", [(128, 128), (150, 97)])
def test_biot_savart_matches_pallas_interpret(B, n1, n2):
    src, areas, J, dst = (
        a.astype(np.float32) for a in _bs_inputs(100 * B + n1, B, n1, n2)
    )
    dz2 = np.float32(1.3)
    ref = np.asarray(
        pallas_biot_savart_batch(src, areas, J, dst, dz2, tm=TM, tn=TN, interpret=True)
    )
    out = kernels.biot_savart_film_to_film_dz2(
        _t(src, torch.float32), _t(areas, torch.float32), _t(J, torch.float32),
        _t(dst, torch.float32), float(dz2),
    ).numpy()
    assert out.shape == (B, n2)
    # float32 sums of n1 terms in different orders: 1e-5 of the largest value.
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dz2", [0.25, 1.0])
def test_biot_savart_matches_jnp_float64(B, dz2):
    src, areas, J, dst = _bs_inputs(7 * B, B, 173, 91)
    ref = np.asarray(
        jkernels.biot_savart_film_to_film_dz2(src, areas, J, dst, dz2, block=32)
    )
    out = kernels.biot_savart_film_to_film_dz2(_t(src), _t(areas), _t(J), _t(dst), dz2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-13 * np.abs(ref).max())


def test_biot_savart_unbatched_shape():
    src, areas, J, dst = _bs_inputs(5, 1, 40, 30)
    out = kernels.biot_savart_film_to_film_dz2(_t(src), _t(areas), _t(J[0]), _t(dst), 0.7)
    batched = kernels.biot_savart_film_to_film_dz2(_t(src), _t(areas), _t(J), _t(dst), 0.7)
    assert out.shape == (30,)
    np.testing.assert_array_equal(out.numpy(), batched[0].numpy())


def test_biot_savart_pair_matches_jax():
    rng = np.random.default_rng(11)
    s1, s2 = _sites(rng, 60), _sites(rng, 45) + 1.0
    w1, w2 = rng.uniform(0.01, 0.05, 60), rng.uniform(0.01, 0.05, 45)
    J1, J2 = rng.standard_normal((2, 60, 2)), rng.standard_normal((2, 45, 2))
    ref = jkernels.biot_savart_pair_dz2(s1, w1, J1, s2, w2, J2, 0.5)
    out = kernels.biot_savart_pair_dz2(
        _t(s1), _t(w1), _t(J1), _t(s2), _t(w2), _t(J2), 0.5
    )
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = dict(cuda_kernels.LAUNCHES)
    pts = _t(_sites(np.random.default_rng(1), 20))
    np.testing.assert_array_equal(
        kernels.q_matrix(pts).numpy(), kernels.q_matrix_plain(pts).numpy()
    )
    assert cuda_kernels.LAUNCHES == before


def test_other_devices_raise():
    with pytest.raises(ValueError, match="Unsupported tensor device"):
        kernels.q_matrix(torch.zeros((4, 2), device="meta"))


@pytest.mark.parametrize(
    "call",
    [
        lambda: cuda_kernels.q_matrix(torch.zeros((4, 2))),
        lambda: cuda_kernels.biot_savart_batch(
            torch.zeros((4, 2)), torch.ones(4), torch.zeros((1, 4, 2)),
            torch.zeros((3, 2)), 1.0,
        ),
        lambda: cuda_kernels.q_apply(torch.zeros((4, 2)), torch.zeros((3, 2)), torch.ones((3, 1))),
        lambda: cuda_kernels.biot_savart_pair(
            torch.zeros((4, 2)), torch.ones(4), torch.zeros((1, 4, 2)),
            torch.zeros((3, 2)), torch.ones(3), torch.zeros((1, 3, 2)), 1.0,
        ),
    ],
)
def test_cuda_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()


def test_cuda_wrappers_refuse_other_dtypes():
    with pytest.raises(TypeError, match="float32 and float64"):
        cuda_kernels.q_matrix(torch.zeros((4, 2), dtype=torch.float16))


def _q_apply_inputs(seed, m, n, k, coincident):
    """Eval and source sites (the first ``coincident`` eval sites coincide
    with source sites) and ``V`` of shape ``(n, k)``, or ``(n,)`` for
    ``k = 0``."""
    rng = np.random.default_rng(seed)
    src = _sites(rng, n)
    ev = np.concatenate([src[:coincident], _sites(rng, m - coincident) + 0.5])
    V = rng.standard_normal((n, k) if k else n)
    return ev, src, V


@pytest.mark.parametrize("k", [0, 1, 5])
@pytest.mark.parametrize("m,n", [(150, 150), (90, 131)])
def test_q_apply_rect_matches_jax_float64(k, m, n):
    ev, src, V = _q_apply_inputs(m + n + k, m, n, k, coincident=m // 3)
    ref = np.asarray(jkernels.q_apply_rect(ev, src, V, block=32))
    out = kernels.q_apply_rect(_t(ev), _t(src), _t(V)).numpy()
    assert out.shape == ref.shape == ((m, k) if k else (m,))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-13 * np.abs(ref).max())
    plain = kernels.q_apply_plain(_t(ev), _t(src), _t(V).reshape(n, -1), block=16).numpy()
    np.testing.assert_allclose(plain.reshape(ref.shape), ref, rtol=1e-12, atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("k", [0, 3])
def test_q_apply_matches_jax_float64(k):
    _, pts, V = _q_apply_inputs(40 + k, 1, 173, k, coincident=0)
    ref = np.asarray(jkernels.q_apply(pts, V, block=32))
    out = kernels.q_apply(_t(pts), _t(V)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-13 * np.abs(ref).max())
    # The square kernel applied matrix-free equals the dense q_matrix product.
    dense = kernels.q_matrix(_t(pts)).numpy() @ V
    np.testing.assert_allclose(out, dense, rtol=1e-12, atol=1e-13 * np.abs(ref).max())


def test_q_apply_coincident_points_contribute_zero():
    pts = _sites(np.random.default_rng(4), 30)
    pts[7] = pts[21]
    out = kernels.q_apply(_t(pts), _t(np.eye(30)[:, [7, 21]])).numpy()
    assert np.isfinite(out).all()
    assert out[7, 1] == 0.0 and out[21, 0] == 0.0


@needs_pallas
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("m,n", [(128, 128), (90, 131)])
def test_q_apply_rect_matches_pallas_interpret(k, m, n):
    ev, src, V = (a.astype(np.float32) for a in _q_apply_inputs(7 * k + m, m, n, k, m // 2))
    ref = np.asarray(pallas_q_apply_rect(ev, src, V, tm=TM, tn=TN, interpret=True))
    out = kernels.q_apply_rect(
        _t(ev, torch.float32), _t(src, torch.float32), _t(V, torch.float32)
    ).numpy()
    assert out.shape == (m, k)
    # float32 sums of n terms in different orders: 1e-5 of the largest value.
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("k", [0, 4])
def test_Q_apply_matches_jax(k):
    rng = np.random.default_rng(30 + k)
    pts = _sites(rng, 150)
    w = rng.uniform(0.01, 0.05, size=150)
    V = rng.standard_normal((150, k) if k else 150)
    ref = np.asarray(jkernels.Q_apply(pts, w, V, block=32))
    out = kernels.Q_apply(_t(pts), _t(w), _t(V)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    dense = kernels.Q_matrix(_t(pts), _t(w)).numpy() @ V
    np.testing.assert_allclose(out, dense, rtol=1e-10, atol=1e-12 * np.abs(ref).max())


def _pair_inputs(seed, B, n1, n2):
    rng = np.random.default_rng(seed)
    s1, s2 = _sites(rng, n1), _sites(rng, n2) + 0.5
    a1, a2 = rng.uniform(0.5, 2.0, n1), rng.uniform(0.5, 2.0, n2)
    J1, J2 = rng.standard_normal((B, n1, 2)), rng.standard_normal((B, n2, 2))
    return s1, a1, J1, s2, a2, J2


@needs_pallas
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n1,n2", [(128, 128), (200, 150)])
def test_biot_savart_pair_plain_matches_pallas_interpret(B, n1, n2):
    args = [a.astype(np.float32) for a in _pair_inputs(B + n1, B, n1, n2)]
    dz2 = np.float32(0.49)
    ref2, ref1 = (
        np.asarray(a)
        for a in pallas_biot_savart_pair(*args, dz2, tm=TM, tn=TN, interpret=True)
    )
    at2, at1 = kernels.biot_savart_pair_plain(
        *(_t(a, torch.float32) for a in args), float(dz2), block=64
    )
    assert at2.shape == (B, n2) and at1.shape == (B, n1)
    # float32 sums of n terms in different orders: 1e-5 of the largest value.
    assert np.abs(at2.numpy() - ref2).max() <= 1e-5 * np.abs(ref2).max()
    assert np.abs(at1.numpy() - ref1).max() <= 1e-5 * np.abs(ref1).max()


@pytest.mark.parametrize("squeeze", [False, True])
def test_biot_savart_pair_coupling_matches_jax_two_passes(monkeypatch, squeeze):
    s1, a1, J1, s2, a2, J2 = _pair_inputs(12, 2, 60, 45)
    if squeeze:
        J1, J2 = J1[0], J2[0]
    ref = jkernels.biot_savart_pair_dz2(s1, a1, J1, s2, a2, J2, 0.5)
    monkeypatch.setenv("SUPERSCREEN_TPU_PAIR_COUPLING", "1")
    out = kernels.biot_savart_pair_dz2(_t(s1), _t(a1), _t(J1), _t(s2), _t(a2), _t(J2), 0.5)
    for a, b in zip(out, ref):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)


# The launch geometry of the pairwise CUDA kernels, computed on the host:
# the library's block geometry is replaced by a stub with the values the C
# sources set (evaluation points per block, source points per tile).
H100_SMS = 132


def _stub_geometry(kernel, dtype, cols):
    if kernel == "biot_savart_pair":
        # 128 threads; 8 film-2 points each in float32 for chunks of 1-2
        # columns (tiles of 64 sources), 4 for 4-8 (tiles of 128); 2 in
        # float64 (tiles of 128, 64 for the 8-column chunk).
        if dtype == torch.float64:
            return 256, (64 if cols > 4 else 128)
        return (1024, 64) if cols <= 2 else (512, 128)
    # 128 threads; 4 points each in float32 (8 in biot_savart's chunk of 8
    # batch columns, used from 5 columns on), 2 in float64.
    if dtype == torch.float64:
        return 256, 128
    return (1024 if kernel == "biot_savart" and cols > 4 else 512), 128


def _split_ranges(n_src, tile, splits):
    """The source range of each split, as csrc/common.cuh split_length and
    the kernels' j_begin / j_end cut it."""
    tiles = -(-n_src // tile)
    length = -(-tiles // splits) * tile
    return [(s * length, min((s + 1) * length, n_src)) for s in range(splits)]


def _check_partition(n_src, tile, splits):
    assert 1 <= splits <= min(-(-n_src // tile), 65535)
    ranges = _split_ranges(n_src, tile, splits)
    # Every split is non-empty and starts on a tile, and every source tile
    # belongs to exactly one split.
    assert all(lo < hi and lo % tile == 0 for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_src
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize(
    "kernel,dtype,n_eval,n_src,cols",
    [
        ("q_apply", torch.float32, 16770, 16770, 1),  # the CG matvec
        ("q_apply", torch.float32, 27298, 27298, 1),  # low-memory row sums
        ("q_apply", torch.float32, 27298, 27298, 7),  # matrix-free self-field
        ("q_apply", torch.float32, 9099, 27298, 2),  # hole vectors
        ("q_apply", torch.float64, 27298, 27298, 1),
        ("biot_savart", torch.float32, 27298, 27298, 1),  # low-memory coupling
        ("biot_savart", torch.float32, 27298, 27298, 8),
        ("biot_savart", torch.float32, 20274, 20274, 1),  # dense coupling
        ("biot_savart", torch.float64, 27298, 27298, 8),
        ("biot_savart_pair", torch.float32, 27298, 27298, 1),
        ("biot_savart_pair", torch.float64, 27298, 27298, 8),
    ],
)
def test_launch_geometry_of_main_path_shapes(monkeypatch, kernel, dtype, n_eval, n_src, cols):
    monkeypatch.setattr(cuda_kernels, "_geometry", _stub_geometry)
    points, tile = _stub_geometry(kernel, dtype, cols)
    shapes = cuda_kernels._partial_shapes(kernel, dtype, n_eval, n_src, cols, H100_SMS)
    splits = shapes[0][0]
    eval_blocks = -(-n_eval // points)
    _check_partition(n_src, tile, splits)
    # At these shapes the grid holds 4 to 8 blocks of 4 warps per SM.
    blocks = eval_blocks * splits
    assert 4 * H100_SMS <= blocks <= 8 * H100_SMS
    # The partial sums the C side indexes: q_apply partial[(s m + i) k + c],
    # biot_savart partial[(s B + b) n2 + i], and the pair kernel's reverse
    # sums rev[(blockIdx.x B + b) n1 + j].
    if kernel == "q_apply":
        assert shapes == [(splits, n_eval, cols)]
    elif kernel == "biot_savart":
        assert shapes == [(splits, cols, n_eval)]
    else:
        assert shapes == [(splits, cols, n_eval), (eval_blocks, cols, n_src)]


@pytest.mark.parametrize("seed", range(4))
def test_source_splits_partition_any_shape(seed):
    rng = np.random.default_rng(seed)
    for _ in range(150):
        tile = int(rng.choice([64, 128]))
        n_src = int(rng.integers(1, 300_000))
        eval_blocks = int(rng.integers(1, 3000))
        sms = int(rng.choice([1, 8, 78, 114, 132]))
        splits = cuda_kernels._source_splits(n_src, tile, eval_blocks, sms)
        _check_partition(n_src, tile, splits)
        blocks = eval_blocks * splits
        tiles = -(-n_src // tile)
        assert blocks <= max(eval_blocks, 8 * sms)
        assert blocks >= min(4 * sms, eval_blocks * tiles) or splits == 1


def test_partial_shapes_follow_the_library_geometry(monkeypatch):
    # Twice the points per block halves the evaluation blocks, which size
    # the pair kernel's reverse partial sums.
    monkeypatch.setattr(cuda_kernels, "_geometry", lambda k, d, c: (1024, 64))
    shapes = cuda_kernels._partial_shapes("biot_savart_pair", torch.float32, 27298, 27298, 2, 132)
    assert shapes[1] == (27, 2, 27298)


# -- the field of a sheet current anywhere in space ----------------------------


def _sheet_tensors(n, m, seed, z=0.6, z0=0.1, on_site=0):
    """A sheet of ``n`` positions at height ``z0`` and ``m`` evaluation
    points at height ``z``, the first ``on_site`` of them on sheet
    positions."""
    rng = np.random.default_rng(seed)
    positions = np.column_stack([rng.uniform(-3, 3, (n, 2)), np.full(n, z0)])
    targets = np.column_stack([rng.uniform(-4, 4, (m, 2)), np.full(m, z)])
    targets[:on_site, :2] = positions[:on_site, :2]
    J = rng.standard_normal((n, 2))
    areas = rng.uniform(0.05, 0.2, n)
    return tuple(torch.as_tensor(a) for a in (targets, positions, J, areas))


def test_field_at_one_height_takes_the_biot_savart_batch_route(monkeypatch):
    """Hz at points of one height equals the blocked plain sum, and goes
    through biot_savart_film_to_film_dz2 with dz2 = (z - z0)^2."""
    targets, positions, J, areas = _sheet_tensors(150, 70, seed=31)
    calls = []
    routed = kernels.biot_savart_film_to_film_dz2

    def spy(*args):
        calls.append(args[-1])
        return routed(*args)

    monkeypatch.setattr(kernels, "biot_savart_film_to_film_dz2", spy)
    out = kernels.biot_savart_2d_field(targets, positions, J, areas, vector=False)
    ref = kernels.biot_savart_2d_field_plain(targets, positions, J, areas, vector=False)
    assert calls == [pytest.approx(0.25)]
    assert out.shape == (70,)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12 * float(ref.abs().max()))
    # The z-component of the vector field is the same sum (plain route).
    vec = kernels.biot_savart_2d_field(targets, positions, J, areas, vector=True)
    assert calls == [pytest.approx(0.25)] and vec.shape == (70, 3)
    np.testing.assert_allclose(vec[:, 2].numpy(), ref.numpy(), rtol=0, atol=1e-12 * float(ref.abs().max()))


@pytest.mark.parametrize("case", ["in_plane_on_sites", "mixed_heights", "tilted_sheet"])
def test_field_cases_that_take_the_plain_route(monkeypatch, case):
    """dz2 = 0 (an evaluation point may sit on a sheet position, whose pair
    must contribute zero), mixed evaluation heights and a sheet that is not
    flat all bypass the unguarded biot_savart_batch sum."""
    targets, positions, J, areas = _sheet_tensors(
        120, 40, seed=37, z=0.1 if case == "in_plane_on_sites" else 0.6, on_site=6
    )
    if case == "mixed_heights":
        targets[::2, 2] += 0.3
    if case == "tilted_sheet":
        positions[::3, 2] -= 0.05

    def refuse(*args):
        raise AssertionError("the unguarded sum must not be used here")

    monkeypatch.setattr(kernels, "biot_savart_film_to_film_dz2", refuse)
    out = kernels.biot_savart_2d_field(targets, positions, J, areas, vector=False)
    assert bool(torch.isfinite(out).all())
    # Against the JAX function, which takes SI inputs and returns tesla: in
    # one system of units the two differ by mu_0.
    expected = np.asarray(
        jkernels.biot_savart_2d_field(
            targets.numpy(), positions.numpy(), J.numpy(), areas.numpy(), vector=False
        )
    ) / 1.25663706212e-06
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-12 * np.abs(expected).max())


def test_vector_potential_matches_jax_and_drops_the_self_term():
    targets, positions, J, areas = _sheet_tensors(130, 50, seed=41, z=0.1, on_site=5)
    out = kernels.vector_potential_2d(
        targets[:, :2], targets[:, 2], positions[:, :2], 0.1, areas, J, block=16
    )
    expected = np.asarray(
        jkernels.vector_potential_2d(
            targets[:, :2].numpy(), targets[:, 2].numpy(), positions[:, :2].numpy(), 0.1,
            areas.numpy(), J.numpy(),
        )
    )
    assert out.shape == (50, 2) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-12 * np.abs(expected).max())


def test_biot_savart_film_to_film_matches_jax():
    targets, positions, J, areas = _sheet_tensors(110, 60, seed=43)
    out = kernels.biot_savart_film_to_film(
        positions[:, :2], 0.1, areas, J, targets[:, :2], 0.6
    )
    expected = np.asarray(
        jkernels.biot_savart_film_to_film(
            positions[:, :2].numpy(), 0.1, areas.numpy(), J.numpy(), targets[:, :2].numpy(), 0.6
        )
    )
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-12 * np.abs(expected).max())


# -- sparse products in gather form --------------------------------------------


@pytest.mark.parametrize("columns", [None, 1, 5])
def test_gather_form_equals_the_scatter_add(columns):
    """The fixed-fan-in gather form of a COO operator (duplicates, empty
    rows and all) against the ``index_add_`` product it replaces."""
    from superscreen_tpu_torch.ops import fem

    rng = np.random.default_rng(47)
    n_rows, n_cols, nnz = 90, 70, 600
    rows = rng.integers(0, n_rows - 5, nnz)  # the last rows stay empty
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz)
    op = fem.COO(rows, cols, vals, (n_rows, n_cols))
    x = torch.as_tensor(rng.standard_normal(n_cols if columns is None else (n_cols, columns)))
    contrib = torch.as_tensor(vals)[(...,) + (None,) * (x.ndim - 1)] * x[torch.as_tensor(cols)]
    expected = torch.zeros((n_rows,) + x.shape[1:], dtype=x.dtype).index_add_(
        0, torch.as_tensor(rows), contrib
    )
    got = op.matvec(x)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=0,
                               atol=1e-14 * float(expected.abs().max()))
    idx, w = op.to_gather(np.float64, "cpu")
    assert idx.shape == w.shape and idx.shape[0] == n_rows
    batch = fem.gather_matvec_batch(idx, w, x.reshape(n_cols, -1).T.contiguous())
    np.testing.assert_allclose(batch.T.numpy().reshape(expected.shape), expected.numpy(), rtol=0,
                               atol=1e-14 * float(expected.abs().max()))
    assert torch.equal(op.matvec(x), got)


def test_brandt_matvec_and_jacobi_diagonal_in_gather_form():
    """The matrix-free operator's Lambda term and its Jacobi diagonal, in
    gather form, against the dense matrix built from the same triplets."""
    from superscreen_tpu_torch.ops import fem, linalg

    rng = np.random.default_rng(53)
    ni = 60
    sites = torch.as_tensor(rng.uniform(-2, 2, (ni, 2)))
    w = torch.as_tensor(rng.uniform(0.05, 0.1, ni))
    diag = torch.as_tensor(rng.uniform(5, 6, ni))
    rows = np.concatenate([rng.integers(0, ni, 300), np.arange(ni)])
    cols = np.concatenate([rng.integers(0, ni, 300), np.arange(ni)])
    lam = fem.COO(rows, cols, rng.standard_normal(len(rows)), (ni, ni)).coalesce()
    lap_idx, lap_w = lam.to_gather(np.float64, "cpu")
    op = dict(sub_sites=sites, w_sub=w, diag=diag, lap_idx=lap_idx, lap_w=lap_w, nonsym=True)
    dense = (-kernels.q_matrix(sites) + torch.diag(diag)) * w[None, :] - lam.to_dense(
        torch.float64, "cpu"
    )
    x = torch.as_tensor(rng.standard_normal((ni, 3)))
    np.testing.assert_allclose(
        linalg.brandt_matvec(op, x).numpy(), (dense @ x).numpy(), rtol=0,
        atol=1e-12 * float((dense @ x).abs().max()),
    )
    p_diag = (dense / w[None, :]).diagonal()
    np.testing.assert_allclose(
        linalg._jacobi_minv(op)[:, 0].numpy(), (1.0 / p_diag).numpy(), rtol=1e-12
    )

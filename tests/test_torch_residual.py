"""``residual_f64`` around its kernel, on the CPU: the plan that cuts one
call's work (``ops/cuda_kernels.residual_plan``), the dtype paths of the
plain version, the callers that pass their tensors as they are (bitwise
the results of the casts they used to make), and the plain version against
the JAX package's ``_residual_f64`` (``superscreen_tpu/certify.py``).  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superscreen_tpu_torch as st
from superscreen_tpu.certify import _residual_f64 as ref_residual_f64
from superscreen_tpu_torch import sweep
from superscreen_tpu_torch.ops import cuda_kernels, kernels, linalg

torch.set_num_threads(2)

SMS = 132
SLOTS = SMS * cuda_kernels._RESIDUAL_BLOCKS_PER_SM
# chip_smoke.py phase 1's shapes (m, n, k), phase 16's dense self-field
# (n = 20,274, k = 6 and 1) and the landscape's blocks.
CARD_SHAPES = [
    (16768, 16768, 1), (16766, 16766, 1), (16768, 16768, 4), (16768, 16768, 8), (5594, 16768, 11),
    (20274, 20274, 6), (20274, 20274, 1), (6715, 6715, 64), (15310, 15310, 2048),
]
ALL_K = list(range(1, 70)) + [100, 127, 128, 129, 1000, 2048]


def _rng_tensor(rng, shape, dtype=torch.float64):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1001, 16768])
def test_plan_covers_every_column_of_r_in_one_call(n):
    """One plan (one launch) at every k: its column blocks hold all k
    columns (the stream route all of them in one block), its splits cover
    ``[0, n)`` in whole tiles with none empty."""
    for k in ALL_K:
        plan = cuda_kernels.residual_plan(257, n, k, SMS)
        if plan.route == "stream":
            assert plan.width == k and plan.col_blocks == 1
        else:
            assert plan.width in (16, 32, 64) and plan.col_blocks == -(-k // plan.width)
            assert (plan.col_blocks - 1) * plan.width < k
        assert plan.tiles == -(-n // plan.tile)
        # The columns each split sums, as the C side cuts them.
        step = plan.split_tiles * plan.tile
        columns = [(s * step, min((s + 1) * step, n)) for s in range(plan.splits)]
        assert plan.splits >= 1
        assert columns[0][0] == 0 and columns[-1][1] == n
        for (lo, hi), (lo2, _) in zip(columns, columns[1:] + [(n, None)]):
            assert lo % plan.tile == 0 and hi == lo2
            assert hi > lo or n == 0
        assert 1 <= plan.grid <= min(plan.items, SLOTS)


def test_plan_switches_route_at_the_stated_k():
    """The stream route below ``RESIDUAL_MMA_MIN_K_ALIGNED`` (rows 16-byte
    aligned) or ``RESIDUAL_MMA_MIN_K``, the tensor-core route from there;
    the C side builds the stream route for exactly those widths and takes
    the plan's rows and tiles."""
    for k in ALL_K:
        for aligned, least in ((False, cuda_kernels.RESIDUAL_MMA_MIN_K),
                               (True, cuda_kernels.RESIDUAL_MMA_MIN_K_ALIGNED)):
            plan = cuda_kernels.residual_plan(1000, 1000, k, SMS, aligned)
            assert plan.route == ("stream" if k < least else "mma"), (k, aligned)
    assert cuda_kernels.residual_plan(1000, 1000, 8, SMS) == cuda_kernels.residual_plan(
        1000, 1000, 8, SMS, False)
    header = (Path(cuda_kernels._CSRC) / "residual_f64.cuh").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", header).group(1))

    assert constant("STREAM_MAX_K") == cuda_kernels.RESIDUAL_MMA_MIN_K_ALIGNED - 1
    assert constant("STREAM_WINDOWS_MAX_K") == cuda_kernels.RESIDUAL_MMA_MIN_K - 1
    assert constant("BLOCKS_PER_SM") == cuda_kernels._RESIDUAL_BLOCKS_PER_SM
    assert constant("STREAM_TILE") == cuda_kernels._RESIDUAL_STREAM["tile"]
    assert constant("MMA_TILE") == cuda_kernels._RESIDUAL_MMA["tile"]
    with pytest.raises(ValueError):
        cuda_kernels.residual_plan(0, 1000, 4, SMS)


@pytest.mark.parametrize("m,n,k", CARD_SHAPES)
def test_plan_fills_the_card_at_the_main_paths_shapes(m, n, k):
    """Every SM gets a block, and the busiest SM works through at most 30 %
    more tiles than an even share of the work would give it (an item
    costs its tiles plus the ring's fill).  The worst of these shapes is
    k = 64 at 6,715 rows: 53 row blocks make 212 items at 4 splits (80 SMs
    hold two) or 265 at 5 (one holds three)."""
    plan = cuda_kernels.residual_plan(m, n, k, SMS, n % 4 == 0)  # rows of a fresh A
    assert plan.grid >= SMS
    overhead = cuda_kernels._RESIDUAL_ITEM_OVERHEAD_TILES
    busiest = -(-plan.items // SMS) * (plan.split_tiles + overhead)
    even = plan.row_blocks * plan.col_blocks * plan.tiles / SMS
    assert busiest <= 1.3 * (even + overhead), plan
    # The partial sums stay a small part of A's bytes.
    assert (plan.splits > 1) * 16 * plan.splits * m * k <= m * n


@pytest.mark.parametrize("m,n,k", CARD_SHAPES)
def test_plan_keeps_the_rows_in_flight_within_the_span(m, n, k):
    """The row blocks that the grid's blocks work on at once (each with
    all its splits and column blocks) span at most
    ``_RESIDUAL_SPAN_BYTES`` of A at every main-path shape: a 20,274^2 A
    (1.64 GB) is cut into splits even where its row blocks alone fill the
    card."""
    plan = cuda_kernels.residual_plan(m, n, k, SMS, n % 4 == 0)  # rows of a fresh A
    in_flight = min(plan.row_blocks, -(-plan.grid // (plan.splits * plan.col_blocks)))
    assert min(m, in_flight * plan.rows) * n * 4 <= cuda_kernels._RESIDUAL_SPAN_BYTES, plan
    if m * n * 4 > cuda_kernels._RESIDUAL_SPAN_BYTES and plan.col_blocks == 1:
        assert plan.splits > 1, plan


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("h_dtype", [None, torch.float32, torch.float64])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64])
def test_plain_dtype_paths_are_the_old_casts_bitwise(x_dtype, h_dtype, out_dtype):
    """The plain version on float32 or float64 X, float32, float64 or no
    H, and either result dtype gives the bits of the old composition:
    ``X.double()``, ``zeros_like`` for no H, ``.to`` of the float64 result."""
    rng = np.random.default_rng(3)
    m, n, k = 301, 257, 6
    A = _rng_tensor(rng, (m, n), torch.float32)
    X = _rng_tensor(rng, (k, n), x_dtype).T  # column-major, as lu_solve returns it
    H = None if h_dtype is None else _rng_tensor(rng, (m, k), h_dtype)
    got = kernels.residual_f64(A, X, H, out_dtype=out_dtype)
    old_H = torch.zeros((m, k), dtype=torch.float64) if H is None else H
    want = kernels.residual_f64_plain(A, X.double(), old_H, block=2048).to(out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.equal(kernels.residual_f64_plain(A, X, H, block=97, out_dtype=out_dtype), got)


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("columns", [1, 5])
def test_system_residual_gives_its_old_bits(h_dtype, columns):
    rng = np.random.default_rng(columns)
    n = 300
    A = (_rng_tensor(rng, (n, n)) + 40 * torch.eye(n, dtype=torch.float64)).float()
    lu = linalg.factor_system(A)
    h = _rng_tensor(rng, (n, columns), h_dtype)
    x = linalg.lu_solve(lu, h.float())
    assert x.mT.is_contiguous()
    for xx in (x, x.contiguous(), x.double()):
        want = kernels.residual_f64(A, xx.double(), h).to(h.dtype)
        got = linalg.system_residual(A, h, xx)
        assert got.dtype == h.dtype and torch.equal(got, want)


@pytest.mark.parametrize("B", [1, 6, 9])
def test_self_field_batch_gives_its_old_bits(B):
    rng = np.random.default_rng(B)
    n = 400
    Qw = _rng_tensor(rng, (n, n), torch.float32)
    weights = torch.as_tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
    g = _rng_tensor(rng, (B, n), torch.float32)
    data = SimpleNamespace(weights=weights, terminal=False, brandt_diag=None, Qw=Qw)
    gT = g.T.double().contiguous()
    want = kernels.residual_f64(Qw, gT, torch.zeros_like(gT)).T.to(g.dtype)
    got = sweep._self_field_batch(data, g)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_solve_film_self_field_gives_its_old_bits():
    """A dense float32 film's self-field in ``solve_film``: the old
    composition (widened ``w g``, zero H, ``.to`` of the result) on the
    stream it returns gives its self-field bit for bit."""
    solve_film = importlib.import_module("superscreen_tpu_torch.solver.solve_film")
    from superscreen_tpu_torch.solver import utils
    device = st.Device(
        "ring", layers=[st.Layer("base", Lambda=0.8, z0=0)],
        films=[st.Polygon("disk", layer="base", points=st.geometry.circle(5, points=70))],
        holes=[st.Polygon("hole", layer="base", points=st.geometry.circle(1.5, points=36))],
        solve_dtype="float32",
    )
    device.make_mesh(min_points=400)
    model = st.factorize_model(device=device, current_units="uA",
                               circulating_currents={"hole": 1.0}, torch_device="cpu")
    info = utils.make_film_info(
        device=device, circulating_currents=model.circulating_currents, torch_device="cpu"
    )["disk"]
    conv = utils.field_conversion_factor("mT", "uA", "um").magnitude
    n = len(device.meshes["disk"].sites)
    out = solve_film.solve_film(
        device=device, applied_field=np.full(n, 0.3 * conv), film_info=info,
        film_system=model.film_systems["disk"], hole_systems=model.hole_systems["disk"],
        field_conversion=conv,
        vortex_flux=float(st.ureg("Phi_0 / mu_0").to("uA * um").magnitude),
    )
    assert info.kernel.dtype == torch.float32
    g = torch.as_tensor(out.stream)
    wg = (info.weights * g)[:, None].double()
    old = kernels.residual_f64(info.kernel, wg, torch.zeros_like(wg))[:, 0].to(torch.float32)
    assert np.array_equal(out.self_field, (old / conv).numpy())


@pytest.mark.parametrize("m,n,B", [(128, 128, 1), (256, 96, 3), (100, 100, 8)])
def test_plain_matches_the_jax_residual(m, n, B):
    """``superscreen_tpu/certify.py``'s ``_residual_f64`` (``R = G A^T + H``,
    ``(B, m)``) against the plain version on the same inputs in float64."""
    rng = np.random.default_rng(m + B)
    A = rng.standard_normal((m, n)).astype(np.float32)
    G = rng.standard_normal((B, n))
    H = rng.standard_normal((B, m))
    blk = 64 if m % 64 == 0 else m
    ref = np.asarray(ref_residual_f64(jnp.asarray(A), jnp.asarray(G), jnp.asarray(H), blk))
    got = kernels.residual_f64(torch.as_tensor(A), torch.as_tensor(G).T, torch.as_tensor(H).T)
    assert got.dtype == torch.float64
    scale = np.abs(ref).max()
    assert np.abs(got.T.numpy() - ref).max() <= 1e-12 * scale

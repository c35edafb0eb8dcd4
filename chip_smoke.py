#!/usr/bin/env python3
"""Smoke test of superscreen_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Each hand-written CUDA kernel against its plain PyTorch version on the
   card, at the shapes of the main path, with CUDA-event timings.
2. The dense multi-film ``solve()`` at real size: a four-ring stack with
   about 20,000 mesh sites per film, factorized and solved with five
   coupling rounds in float32.  The kernel launch counters must show that
   the main path went through both kernels, and every film's final
   relative residual must be at most 1e-4.
3. Accuracy: a two-ring device solved on the card in float32 against the
   same package on the CPU in float64 (plain PyTorch kernels).
4. The low-memory path at real size: the four-ring stack of bench.py's
   build_large at 27,000 sites per film, every film above
   MAX_DENSE_KERNEL_SIZE, factorized (materialized interior systems, LU)
   and solved with five coupling rounds in float32.  No film may hold a
   dense kernel, the q_apply kernel must have run at least three times per
   film, and every final relative residual must be at most 1e-4.
5. The same stack with SUPERSCREEN_TPU_LARGE_FACTOR=cg (matrix-free CG):
   streams within 1e-4 of phase 4's; CG iterations and the final
   residuals are printed.
6. Phase 4's model solved again with SUPERSCREEN_TPU_PAIR_COUPLING=1 (the
   biot_savart_pair kernel): streams within 1e-5 of phase 4's; warm solves
   with and without the pair kernel timed in turns, and the pair-coupled
   solve profiled.

7. The B-point sweep at full width: ``solve_many`` on phase 4's model with
   the eight fields of bench.py's headline (0.1 to 1.0 mT), five coupling
   rounds, float32.  Every film's final relative residual must be at most
   1e-4 at all eight points; point 7 must match a ``solve()`` of the
   same drive within 1e-4 (and phase 4's, whose float32 refinement
   residual costs it up to 9e-5, within 2e-4) and, without circulating
   currents, point 0 must be point 7 divided by 10 within 1e-4, with the
   inner rounds unrefined (the default) and refined
   (SUPERSCREEN_TPU_INNER_REFINE=2); the pair-coupled sweep must match
   the two-pass one within 1e-5.  Prints the cold and warm wall time, a
   profile of the warm sweep, the time per sweep point beside 8 warm
   B = 1 solves, the warm sweep with
   SUPERSCREEN_TPU_INNER_REFINE=2 in turns with the default, and what
   the sweep loses when its refinement residuals are float32 GEMMs
   instead of float64 sums.
8. Vortices, terminals and a position-dependent Lambda at real size: a
   strip of about 20,000 sites with a hole, a source and a drain terminal
   and a Gaussian weak spot in Lambda, under a ring of about 26,000 sites
   at z0 = 1 on the low-memory path, two vortices in the strip.
   ``solve_many`` sweeps the bias current and the vortex amplitudes over
   eight points with three coupling rounds.  Residuals at most 1e-4; with
   the drive alone the current through three cross-sections of the strip
   (``Solution.current_through_path``, 4,001 points each) equals the drive
   current within 1e-3 at every sweep point, and in the full sweep within
   1e-2 of the gross current crossing the section; float32 on the card against
   float64 on the CPU on a coarse copy within 1e-4; with
   SUPERSCREEN_TPU_LARGE_FACTOR=cg the ring takes the BiCGStab route, its
   streams are within 1e-4 of LU's, and a second factorization and sweep
   take the same number of iterations and give the same bits.  The
   in-film self-field of the strip (biot_savart_batch with the triangle
   centroids as sources) is held against its plain version and timed.
9. Post-processing at full width, on phase 4's model and solutions (the
   uncut 27,000-site stack, float32) and a sweep of it: the field on a
   256 x 256 map above the stack (``field_at_position``: one
   biot_savart_batch launch per film, held against the plain version and
   timed beside its bound), the vector field and the vector potential on
   the same map (Bz against the curl of A), interpolation at 100,000
   random points of one film (none may be lost; point location is
   float64), the fluxoids of the four holes, the mutual-inductance matrix
   in float32 and in float64 on the card (within 1e-3 of each other), and
   ``find_fluxoid_solution`` with one flux quantum in the outer ring's
   hole (targets met within 1e-3 Phi_0).

Phase 1 also runs q_apply, biot_savart_batch and biot_savart_pair against
their plain versions on the 27,000-site films, the pair kernel against two
biot_savart_batch passes (its time and its ratio to theirs), and two
launches of each register-blocked kernel (q_apply, biot_savart_batch,
biot_savart_pair) against each other, which must agree to the bit.  Phase 4 also times q_apply at the shape of the CG matvec (the
interior sites of one film), phase 7 at the shape of the sweep's
self-field (all sites, B + 1 columns).  Every kernel time is printed beside its
bound: the least time the card could take for the same work, from the
bytes it must move and the operations it must do (H100_RATES).  Each
path's launch counters are set to 0 just before it runs and read just
after.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# Tolerances, relative to max|plain|.  float32: both versions round each
# pair term at ~6e-8 and sum 2e4 terms in different orders (the kernel in
# registers, the plain version through cuBLAS), so differences of ~1e-6
# are expected; 1e-5 leaves a margin.  float64: the same argument at
# ~1.1e-16 per term.
TOL = {"float32": 1e-5, "float64": 1e-12}
RESIDUAL_MAX = 1e-4
STREAM_REL_MAX = 1e-4
# CG stops at a relative residual of 1e-6 of its own iteration; float32
# LU and CG answers then differ at the level of the LU residual (~1e-5).
CG_STREAM_REL_MAX = 1e-4
# One geometry pass or two: the same sums in another order, in float32.
PAIR_STREAM_REL_MAX = 1e-5
SITES_DENSE = 20000
SITES_LARGE = 27000
ITERATIONS = 5
# The B-point sweep of bench.py's headline: eight fields, five rounds.
SWEEP_FIELDS = np.linspace(0.1, 1.0, 8)
# Phase 8: sites of the terminal strip (dense at any size; kept below
# MAX_DENSE_KERNEL_SIZE) and of the ring above it (low-memory path), the
# sites per film of the coarse copy, and the coupling rounds.
SITES_STRIP = 20000
SITES_RING = 26000
SITES_COARSE = 1500
TRANSPORT_ITERATIONS = 3
EDGE_CURRENT_TOL = 1e-3
# Current conservation of the JAX package's transport benchmark, printed
# beside the port's.
JAX_CURRENT_CONSERVATION = 2.4e-4
# The full sweep's net current through a section, against the gross current
# crossing it both ways (screening currents of the field and the vortices,
# hundreds of times the drive): a quadrature bound, measured ~2e-3 on a
# 2,000-site copy of the strip.
GROSS_CURRENT_TOL = 1e-2
# Phase 9: the side of the field map, the height of the map above the
# stack (the top film lies at z0 = 1.5), the number of interpolation
# queries, and the limits.
MAP_SIDE = 256
MAP_HEIGHT = 2.0
INTERP_POINTS = 100000
# Bz from central differences of A on the map's grid (spacing 0.066)
# against the summed Bz, relative to max|Bz|; the JAX package's own test
# allows 5e-2.
CURL_TOL = 5e-2
SITE_VALUE_TOL = 1e-6
MUTUAL_F32_TOL = 1e-3
FLUXOID_TOL = 1e-3
# The JAX package's Huber mutual inductance against float64, after its
# float64 polish, printed beside the port's unpolished float32 figure.
JAX_MUTUAL_REL_ERR = 5.09e-6
# The torch device of the sweep phases.
CARD = "cuda"

# Peak rates of an H100 SXM at its 700 W limit (132 SMs at 1.98 GHz;
# NVIDIA's data sheet): HBM bytes, FP32 and FP64 operations outside the
# tensor cores (an FMA counts 2), and reciprocal square roots on the
# special-function units (16 per clock per SM).
H100_RATES = {"bytes": 3.35e12, "float32": 66.9e12, "float64": 33.5e12, "rsqrt": 4.18e12}


def _flops_per_pair(kernel, cols):
    """Floating-point operations per pair besides the reciprocal square
    root: the differences, the squared distance and the cube, then per
    column one FMA (q_apply), two (biot_savart_batch, K = (dx, dy) r^-3
    formed once) or four (the pair kernel, both directions)."""
    return {"q_matrix": 8, "q_apply": 7 + 2 * cols, "biot_savart_batch": 10 + 4 * cols,
            "biot_savart_pair": 10 + 8 * cols}[kernel]


def _bound(kernel, dtype, n_eval, n_src, cols):
    """The least time in ms that the card could take for a launch, and what
    sets it: each input read and each output written once over the HBM
    rate, the pairs' reciprocal square roots over the special-function
    rate, or their other operations over the FP32 (FP64) rate."""
    name = str(dtype).split(".")[1]
    size = 4 if name == "float32" else 8
    pairs = n_eval * n_src
    values = {  # inputs read + outputs written
        "q_matrix": 2 * n_src + n_eval * n_src,
        "q_apply": 2 * n_eval + (2 + cols) * n_src + n_eval * cols,
        "biot_savart_batch": (3 + 2 * cols) * n_src + (2 + cols) * n_eval,
        "biot_savart_pair": (3 + 3 * cols) * (n_src + n_eval),
    }[kernel]
    times = {
        "bytes": values * size / H100_RATES["bytes"],
        "rsqrt": pairs / H100_RATES["rsqrt"],
        name: pairs * _flops_per_pair(kernel, cols) / H100_RATES[name],
    }
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def _bound_text(bound, ms):
    return f"bound_ms={bound[0]:.4f} ({bound[1]}) share_of_bound={bound[0] / ms:.3f}"


def _row(abs_err, ms, plain_ms, bound):
    """A kernel's entry of the summary line (no single PyTorch call computes
    any of these functions, so there is no library time)."""
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by="bytes" if bound[1] == "bytes" else "operations", library_ms=None)


def _require(condition, message="check failed"):
    if not condition:
        raise RuntimeError(message)


def _timed(torch, fn, reps):
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels(torch, kernels, cuda_kernels, device):
    """Kernel versus plain version on the card, on the mesh sites of the
    main path; returns per-kernel rows for the summary line."""
    rng = np.random.default_rng(1234)
    meshes = list(device.meshes.values())
    rows = {}
    for n, dtype in ((len(meshes[0].sites), torch.float32), (4096, torch.float64)):
        pts = torch.as_tensor(meshes[0].sites[:n], dtype=dtype, device="cuda")
        out = cuda_kernels.q_matrix(pts)
        ref = kernels.q_matrix_plain(pts)
        torch.cuda.synchronize()
        _require(out.shape == (n, n) and bool(torch.isfinite(out).all()))
        abs_err = float((out - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        name = str(dtype).split(".")[1]
        ms = _timed(torch, lambda: cuda_kernels.q_matrix(pts), 10)
        plain_ms = _timed(torch, lambda: kernels.q_matrix_plain(pts), 3)
        bound = _bound("q_matrix", dtype, n, n, 0)
        print(
            f"phase1 q_matrix n={n} {name}: max_abs_err={abs_err:.3e} "
            f"rel_err={rel:.3e} (limit {TOL[name]:.0e}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} {_bound_text(bound, ms)}"
        )
        _require(rel <= TOL[name], f"q_matrix {name} disagrees: {rel:.3e}")
        if dtype == torch.float32:
            rows["q_matrix"] = _row(abs_err, ms, plain_ms, bound)
        del out, ref
    torch.cuda.empty_cache()
    # Film 0 (z0 = 0) acting on film 1 (z0 = 0.5), as in a coupling round.
    n1, n2 = len(meshes[0].sites), len(meshes[1].sites)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        src = torch.as_tensor(meshes[0].sites, dtype=dtype, device="cuda")
        dst = torch.as_tensor(meshes[1].sites, dtype=dtype, device="cuda")
        areas = torch.as_tensor(meshes[0].vertex_areas, dtype=dtype, device="cuda")
        for B in (1, 8):
            J = torch.as_tensor(rng.standard_normal((B, n1, 2)), dtype=dtype, device="cuda")
            for dz2 in (0.25, 1.0):
                out = cuda_kernels.biot_savart_batch(src, areas, J, dst, dz2)
                ref = kernels.biot_savart_plain(src, areas, J, dst, dz2)
                torch.cuda.synchronize()
                _require(out.shape == (B, n2) and bool(torch.isfinite(out).all()))
                abs_err = float((out - ref).abs().max())
                rel = abs_err / float(ref.abs().max())
                ms = _timed(
                    torch, lambda: cuda_kernels.biot_savart_batch(src, areas, J, dst, dz2), 10
                )
                plain_ms = _timed(
                    torch, lambda: kernels.biot_savart_plain(src, areas, J, dst, dz2), 3
                )
                bound = _bound("biot_savart_batch", dtype, n2, n1, B)
                print(
                    f"phase1 biot_savart_batch n1={n1} n2={n2} B={B} dz2={dz2} {name}: "
                    f"max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL[name]:.0e}) "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {_bound_text(bound, ms)}"
                )
                _require(rel <= TOL[name], f"biot_savart_batch {name} disagrees: {rel:.3e}")
                if dtype == torch.float32 and B == 1:
                    row = rows.setdefault(
                        "biot_savart_batch", _row(0.0, ms, plain_ms, bound)
                    )
                    row["max_abs_err"] = max(row["max_abs_err"], abs_err)
    return rows


def _check_against_plain(torch, label, dtype, out, ref):
    """Max abs and relative (to max|plain|) error; fails above TOL."""
    torch.cuda.synchronize()
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    abs_err, rel = 0.0, 0.0
    for o, r in zip(outs, refs):
        _require(o.shape == r.shape and bool(torch.isfinite(o).all()), f"{label}: bad output")
        err = float((o - r).abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / float(r.abs().max()))
    name = str(dtype).split(".")[1]
    _require(rel <= TOL[name], f"{label} disagrees: {rel:.3e}")
    return abs_err, rel


def _check_deterministic(torch, label, fn):
    """Two launches on the same inputs must give the same bits (the splits
    are added in a fixed order, without atomics); ``fn`` returns a tensor or
    a tuple of tensors."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    firsts, seconds = (first, second) if isinstance(first, tuple) else ((first,), (second,))
    _require(all(torch.equal(a, b) for a, b in zip(firsts, seconds)), f"{label}: two launches differ")
    print(f"phase1 {label}: two launches are bitwise equal")


def phase_lowmem_kernels(torch, kernels, cuda_kernels, device):
    """q_apply and biot_savart_pair against their plain versions on the
    sites of the 27,000-site films, and the pair kernel against two
    biot_savart_batch passes; returns their rows for the summary line."""
    rng = np.random.default_rng(4321)
    meshes = list(device.meshes.values())
    rows = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        sites = torch.as_tensor(meshes[0].sites, dtype=dtype, device="cuda")
        n = sites.shape[0]
        for shape, ev in (("square", sites), ("rect", sites[: n // 3].contiguous())):
            for k in (1, 7):
                V = torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype, device="cuda")
                abs_err, rel = _check_against_plain(
                    torch, f"q_apply {shape} k={k} {name}", dtype,
                    cuda_kernels.q_apply(ev, sites, V), kernels.q_apply_plain(ev, sites, V),
                )
                ms = _timed(torch, lambda: cuda_kernels.q_apply(ev, sites, V), 10)
                plain_ms = _timed(torch, lambda: kernels.q_apply_plain(ev, sites, V), 3)
                bound = _bound("q_apply", dtype, ev.shape[0], n, k)
                print(
                    f"phase1 q_apply {shape} m={ev.shape[0]} n={n} k={k} {name}: "
                    f"max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL[name]:.0e}) "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {_bound_text(bound, ms)}"
                )
                if dtype == torch.float32 and shape == "square" and k == 1:
                    rows["q_apply"] = _row(abs_err, ms, plain_ms, bound)
                if shape == "square" and k == 7:
                    _check_deterministic(torch, f"q_apply {name}", lambda: cuda_kernels.q_apply(ev, sites, V))
    torch.cuda.empty_cache()
    # Film 0 (z0 = 0) and film 1 (z0 = 0.5), as in a coupling round.
    n1, n2 = len(meshes[0].sites), len(meshes[1].sites)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device="cuda")

        s1, s2 = t(meshes[0].sites), t(meshes[1].sites)
        a1, a2 = t(meshes[0].vertex_areas), t(meshes[1].vertex_areas)
        for B in (1, 8):
            J1, J2 = t(rng.standard_normal((B, n1, 2))), t(rng.standard_normal((B, n2, 2)))
            # One pass of the low-memory coupling: film 0 acting on film 1.
            abs_err, rel = _check_against_plain(
                torch, f"biot_savart_batch B={B} {name}", dtype,
                cuda_kernels.biot_savart_batch(s1, a1, J1, s2, 0.25),
                kernels.biot_savart_plain(s1, a1, J1, s2, 0.25),
            )
            ms = _timed(torch, lambda: cuda_kernels.biot_savart_batch(s1, a1, J1, s2, 0.25), 10)
            plain_ms = _timed(torch, lambda: kernels.biot_savart_plain(s1, a1, J1, s2, 0.25), 3)
            bound = _bound("biot_savart_batch", dtype, n2, n1, B)
            print(
                f"phase1 biot_savart_batch n1={n1} n2={n2} B={B} dz2=0.25 {name}: "
                f"max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL[name]:.0e}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {_bound_text(bound, ms)}"
            )
            if B == 8:
                _check_deterministic(
                    torch, f"biot_savart_batch {name}",
                    lambda: cuda_kernels.biot_savart_batch(s1, a1, J1, s2, 0.25),
                )
            args = (s1, a1, J1, s2, a2, J2, 0.25)
            abs_err, rel = _check_against_plain(
                torch, f"biot_savart_pair B={B} {name}", dtype,
                cuda_kernels.biot_savart_pair(*args), kernels.biot_savart_pair_plain(*args),
            )

            def two_passes():
                cuda_kernels.biot_savart_batch(s1, a1, J1, s2, 0.25)
                cuda_kernels.biot_savart_batch(s2, a2, J2, s1, 0.25)

            ms = _timed(torch, lambda: cuda_kernels.biot_savart_pair(*args), 10)
            two_ms = _timed(torch, two_passes, 10)
            plain_ms = _timed(torch, lambda: kernels.biot_savart_pair_plain(*args), 3)
            bound = _bound("biot_savart_pair", dtype, n2, n1, B)
            print(
                f"phase1 biot_savart_pair n1={n1} n2={n2} B={B} dz2=0.25 {name}: "
                f"max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL[name]:.0e}) "
                f"kernel_ms={ms:.4f} two_batch_passes_ms={two_ms:.4f} "
                f"pair_to_two_passes={ms / two_ms:.3f} plain_ms={plain_ms:.4f} "
                f"{_bound_text(bound, ms)}"
            )
            _check_deterministic(
                torch, f"biot_savart_pair B={B} {name}", lambda: cuda_kernels.biot_savart_pair(*args)
            )
            if dtype == torch.float32 and B == 1:
                rows["biot_savart_pair"] = _row(abs_err, ms, plain_ms, bound)
    torch.cuda.empty_cache()
    return rows


def four_ring_stack(st, sites_per_film):
    """The four-ring stack of bench.py's build_large: radii 7.5 to 4.5,
    holes at half radius, Lambda = 0.5 + 0.25 i, z0 = 0.5 i."""
    layers, films, holes = [], [], []
    for i, r in enumerate([7.5, 6.5, 5.5, 4.5]):
        layers.append(st.Layer(f"layer{i}", Lambda=0.5 + 0.25 * i, z0=0.5 * i))
        films.append(
            st.Polygon(f"ring{i}", layer=f"layer{i}", points=st.geometry.circle(r, points=100))
        )
        holes.append(
            st.Polygon(f"hole{i}", layer=f"layer{i}", points=st.geometry.circle(r / 2, points=60))
        )
    device = st.Device("four_rings", layers=layers, films=films, holes=holes)
    device.make_mesh(min_points=sites_per_film)
    return device


def two_rings(st, sites_per_film):
    """The two-ring device of bench.py's build_two_layer."""
    layers = [st.Layer("layer0", Lambda=1.0, z0=0), st.Layer("layer1", Lambda=0.5, z0=1)]
    films = [
        st.Polygon("big_ring", layer="layer0", points=st.geometry.circle(7.5, points=120)),
        st.Polygon("little_ring", layer="layer1", points=st.geometry.circle(5, points=100)),
    ]
    holes = [
        st.Polygon("big_hole", layer="layer0", points=st.geometry.circle(3.75, points=70)),
        st.Polygon("little_hole", layer="layer1", points=st.geometry.circle(2.5, points=60)),
    ]
    device = st.Device("two_rings", layers=layers, films=films, holes=holes)
    device.make_mesh(min_points=sites_per_film)
    return device


def _reset_launches(cuda_kernels):
    for key in cuda_kernels.LAUNCHES:
        cuda_kernels.LAUNCHES[key] = 0


def _solve(torch, st, model):
    """``solve`` with ITERATIONS coupling rounds; returns the solutions and
    the wall time, ended by a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solutions = st.solve(
        model=model,
        applied_field=st.sources.ConstantField(1.0),
        iterations=ITERATIONS,
        torch_device=CARD,
    )
    torch.cuda.synchronize()
    return solutions, time.perf_counter() - t0


def _factorize_and_solve(torch, st, cuda_kernels, device, label):
    """Factorizes ``device`` and solves it with ITERATIONS coupling rounds,
    with the launch counters set to 0 just before; checks that every output
    is finite and returns the model, the solutions and the launch counts."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(cuda_kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = st.factorize_model(
        device=device,
        current_units="uA",
        circulating_currents={"hole0": "1 mA"},
        torch_device="cuda",
    )
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    solutions, t_solve = _solve(torch, st, model)
    launches = dict(cuda_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(
        f"{label} times: factorize_s={t_factor:.3f} "
        f"solve_s={t_solve:.3f} (iterations={ITERATIONS}) peak_memory_GB={peak_gb:.3f}"
    )
    print(f"{label} launches: {launches}")
    _require(len(solutions) == ITERATIONS + 1)
    _require(set(model.film_data) == set(device.films))
    for name in device.films:
        for sol in solutions:
            fs = sol.film_solutions[name]
            outputs = [fs.stream, fs.current_density, fs.self_field, fs.applied_field]
            if fs.field_from_other_films is not None:
                outputs.append(fs.field_from_other_films)
            for arr in outputs:
                _require(np.all(np.isfinite(arr)), f"non-finite output in {name}")
    return model, solutions, launches


def _check_residuals(torch, model, solution, label, limit=RESIDUAL_MAX):
    """Prints each film's final relative residual ``||h + A g|| / ||h||``
    (through the matrix-free operator for a CG film), which must be finite
    and, where ``limit`` is given, at most ``limit``."""
    from superscreen_tpu_torch.solver.utils import field_conversion_factor
    from superscreen_tpu_torch.sweep import relative_residual

    device = model.device
    conv = field_conversion_factor(
        "mT", "uA", length_units=device.length_units, ureg=device.ureg
    ).magnitude
    for name in device.films:
        fs = solution.film_solutions[name]
        data = model.film_data[name]
        dtype = data.weights.dtype
        Hz = (fs.applied_field + fs.field_from_other_films) * conv
        I_circ = [[model.circulating_currents.get(h, 0.0) for h in data.hole_names]]
        res = float(
            relative_residual(
                data,
                torch.as_tensor(Hz[None], dtype=dtype, device="cuda"),
                torch.as_tensor(I_circ, dtype=dtype, device="cuda"),
                torch.as_tensor(fs.stream[None], dtype=dtype, device="cuda"),
            )[0]
        )
        print(f"{label} {name}: final relative residual {res:.3e} (limit {limit})")
        _require(np.isfinite(res) and (limit is None or res <= limit), f"{name} residual {res:.3e}")


def _profile_solve(torch, st, model, label):
    """A warm ``solve`` of ``model`` under torch.profiler (see
    :func:`_profile`)."""
    _profile(torch, lambda: _solve(torch, st, model)[1], label)


def _profile(torch, run, label):
    """``run`` (which returns its wall time, ended by a synchronise) once to
    warm up and once under torch.profiler: prints its wall time (profiled),
    the device time (the kernels' summed self time), the device's idle
    share of the wall, and the kernels that take the most device time, with
    their launch counts."""
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) is not None and e.device_type.name == "CUDA"
    ]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(
        f"{label}: wall_ms={wall * 1e3:.1f} (profiled) device_ms={device_ms:.1f} "
        f"idle_share={1 - device_ms / (wall * 1e3):.3f}"
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(
            f"{label}   {e.self_device_time_total / 1e3:9.3f} ms "
            f"({e.self_device_time_total / 1e3 / device_ms:6.1%}) x{e.count:<6d} {e.key[:90]}"
        )


def _stream_error(solutions, reference):
    """Largest relative stream difference over the films of the last round."""
    worst = 0.0
    for name, fs in reference[-1].film_solutions.items():
        a = solutions[-1].film_solutions[name].stream.astype(np.float64)
        b = fs.stream.astype(np.float64)
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    return worst


def phase_solve(torch, st, cuda_kernels, device):
    """The dense multi-film solve at real size on the meshed ``device``;
    returns the launch counts."""
    from superscreen_tpu_torch.solver.utils import MAX_DENSE_KERNEL_SIZE

    sizes = {name: len(mesh.sites) for name, mesh in device.meshes.items()}
    print(f"phase2 mesh sites per film: {sizes}")
    _require(all(n <= MAX_DENSE_KERNEL_SIZE for n in sizes.values()), sizes)
    model, solutions, launches = _factorize_and_solve(torch, st, cuda_kernels, device, "phase2")
    for name in device.films:
        data = model.film_data[name]
        _require(data.Qw.shape == (sizes[name], sizes[name]), "film not on the dense path")
    _require(launches["q_matrix"] >= len(device.films), launches)
    _require(launches["biot_savart_batch"] >= 12 * ITERATIONS, launches)
    _check_residuals(torch, model, solutions[-1], "phase2")
    return launches


def phase_lowmem(torch, st, cuda_kernels, device):
    """The low-memory path at real size: every film above
    MAX_DENSE_KERNEL_SIZE, materialized interior systems, LU.  Returns the
    model, its solutions and the launch counts."""
    from superscreen_tpu_torch.ops import linalg
    from superscreen_tpu_torch.solver.utils import MAX_DENSE_KERNEL_SIZE

    sizes = {name: len(mesh.sites) for name, mesh in device.meshes.items()}
    print(f"phase4 mesh sites per film: {sizes}")
    _require(all(n > MAX_DENSE_KERNEL_SIZE for n in sizes.values()), sizes)
    model, solutions, launches = _factorize_and_solve(torch, st, cuda_kernels, device, "phase4")
    interiors = {name: len(model.film_systems[name].indices) for name in device.films}
    print(f"phase4 interior unknowns per film: {interiors}")
    for name in device.films:
        info, data = model.film_info[name], model.film_data[name]
        _require(not info.dense_kernel and info.kernel is None, f"{name} holds a dense kernel")
        _require(data.Qw is None and data.fac_kind == "lu", f"{name} not on the low-memory LU path")
    _require(launches["q_apply"] >= 3 * len(device.films), launches)
    _require(launches["q_matrix"] >= len(device.films), launches)
    _require(launches["biot_savart_batch"] >= 12 * ITERATIONS, launches)
    _check_residuals(torch, model, solutions[-1], "phase4")
    # The shape of the CG matvec: the interior sites of the first film (the
    # q-block that brandt_matvec applies), k = 1.
    name = next(iter(device.films))
    _time_q_apply(
        torch, "phase4 CG-matvec shape",
        device.meshes[name].sites[model.film_systems[name].indices], 1,
    )
    _profile_solve(torch, st, model, "phase4 profile of the warm LU solve")
    # The peak of one film's factorization, for the materialized ceiling:
    # A, the -A handed to lu_factor, the packed LU and the solver's
    # workspace, per ni^2.
    name = next(iter(device.films))
    A = model.film_systems[name].A
    ni = A.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lu_perm = linalg.factor_system(A)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + A.numel() * A.element_size()
    del lu_perm
    print(
        f"phase4 factor_system peak at ni={ni}: {peak / 1e9:.3f} GB, "
        f"{peak / ni**2:.3f} bytes per ni^2 ({A.dtype})"
    )
    return model, solutions, launches


def _time_q_apply(torch, label, sites, k):
    """q_apply on the square of ``sites`` with ``k`` columns (float32)
    against its plain version, with its time beside its bound."""
    from superscreen_tpu_torch.ops import cuda_kernels, kernels

    sub = torch.as_tensor(sites, dtype=torch.float32, device="cuda")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((len(sites), k)),
                        dtype=torch.float32, device="cuda")
    abs_err, rel = _check_against_plain(
        torch, f"q_apply {label}", torch.float32,
        cuda_kernels.q_apply(sub, sub, x), kernels.q_apply_plain(sub, sub, x),
    )
    ms = _timed(torch, lambda: cuda_kernels.q_apply(sub, sub, x), 20)
    plain_ms = _timed(torch, lambda: kernels.q_apply_plain(sub, sub, x), 3)
    bound = _bound("q_apply", torch.float32, len(sites), len(sites), k)
    print(
        f"q_apply {label} m=n={len(sites)} k={k} float32: "
        f"max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL['float32']:.0e}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {_bound_text(bound, ms)}"
    )


@contextlib.contextmanager
def _pair_coupling(on):
    """SUPERSCREEN_TPU_PAIR_COUPLING=1 inside the block when ``on``."""
    with _environ(SUPERSCREEN_TPU_PAIR_COUPLING="1") if on else contextlib.nullcontext():
        yield


def phase_pair(torch, st, cuda_kernels, model, two_pass):
    """Phase 4's model solved again with SUPERSCREEN_TPU_PAIR_COUPLING=1,
    then warm solves with and without it timed in turns (two passes, pair,
    pair, two passes, twice) and a profile of the pair-coupled solve;
    returns the launch counts of one pair-coupled solve."""
    with _pair_coupling(True):
        _reset_launches(cuda_kernels)
        solutions, _ = _solve(torch, st, model)
        launches = dict(cuda_kernels.LAUNCHES)
    n_films = len(model.device.films)
    pairs = n_films * (n_films - 1) // 2
    err = _stream_error(solutions, two_pass)
    times = {False: [], True: []}
    for pair in (False, True, True, False) * 2:
        with _pair_coupling(pair):
            times[pair].append(_solve(torch, st, model)[1])
    two_s, pair_s = (sum(times[k]) / len(times[k]) for k in (False, True))
    print(
        f"phase6 warm solve_s in turns (iterations={ITERATIONS}): two passes {two_s:.4f} "
        f"{[round(t, 4) for t in times[False]]}, pair {pair_s:.4f} "
        f"{[round(t, 4) for t in times[True]]}; launches {launches}; max relative stream "
        f"difference {err:.3e} (limit {PAIR_STREAM_REL_MAX:.0e})"
    )
    _require(launches["biot_savart_pair"] >= pairs * ITERATIONS, launches)
    _require(launches["biot_savart_batch"] == 0, launches)
    _require(err <= PAIR_STREAM_REL_MAX, f"pair stream difference {err:.3e}")
    with _pair_coupling(True):
        _profile_solve(torch, st, model, "phase6 profile of the warm pair-coupled solve")
    return launches


def phase_cg(torch, st, cuda_kernels, device, lu_solutions):
    """The stack factorized with SUPERSCREEN_TPU_LARGE_FACTOR=cg and solved
    matrix-free; streams against phase 4's."""
    from superscreen_tpu_torch.ops import linalg

    os.environ["SUPERSCREEN_TPU_LARGE_FACTOR"] = "cg"
    try:
        linalg.CG_STATS.update(solves=0, iterations=0, max_residual=0.0)
        model, solutions, launches = _factorize_and_solve(
            torch, st, cuda_kernels, device, "phase5"
        )
    finally:
        del os.environ["SUPERSCREEN_TPU_LARGE_FACTOR"]
    stats = dict(linalg.CG_STATS)
    for name in device.films:
        data = model.film_data[name]
        _require(data.fac_kind == "cg" and data.A is None and data.Qw is None, name)
    print(
        f"phase5 CG: {stats['solves']} solves, {stats['iterations']} iterations "
        f"({stats['iterations'] / max(stats['solves'], 1):.1f} per solve), largest "
        f"final CG residual {stats['max_residual']:.3e}"
    )
    _require(launches["q_apply"] >= stats["iterations"], launches)
    # CG stops on its own recurrence residual (1e-6), which in float32
    # drifts from the true one; what it must match is the LU answer.
    _check_residuals(torch, model, solutions[-1], "phase5", limit=None)
    err = _stream_error(solutions, lu_solutions)
    print(f"phase5 max relative stream difference to LU {err:.3e} (limit {CG_STREAM_REL_MAX:.0e})")
    _require(err <= CG_STREAM_REL_MAX, f"CG stream difference {err:.3e}")
    _profile_solve(torch, st, model, "phase5 profile of the warm CG solve")


def phase_accuracy(st):
    """float32 on the card against float64 on the CPU, same mesh."""
    gpu_dev = two_rings(st, 3000)
    cpu_dev = gpu_dev.copy()
    cpu_dev.solve_dtype = "float64"
    kwargs = dict(
        applied_field=st.sources.ConstantField(1.0),
        circulating_currents={"big_hole": "1 mA"},
        iterations=3,
    )
    gpu = st.solve(gpu_dev, torch_device="cuda", **kwargs)[-1]
    cpu = st.solve(cpu_dev, torch_device="cpu", **kwargs)[-1]
    worst = 0.0
    for name in gpu_dev.films:
        a = gpu.film_solutions[name].stream.astype(np.float64)
        b = cpu.film_solutions[name].stream
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        print(f"phase3 {name} ({len(b)} sites): max relative stream error {rel:.3e}")
        worst = max(worst, rel)
    _require(worst <= STREAM_REL_MAX, f"stream error {worst:.3e}")


@contextlib.contextmanager
def _environ(**values):
    """The given environment variables set inside the block."""
    previous = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in previous.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value


@contextlib.contextmanager
def _f64_residuals_from(columns):
    """Inside the block a float32 system's refinement residual is
    accumulated in float64 from ``columns`` right-hand sides on
    (ops.linalg.F64_RESIDUAL_MIN_COLS)."""
    from superscreen_tpu_torch.ops import linalg

    linalg.F64_RESIDUAL_MIN_COLS, previous = columns, linalg.F64_RESIDUAL_MIN_COLS
    try:
        yield
    finally:
        linalg.F64_RESIDUAL_MIN_COLS = previous


def _sweep(torch, st, **kwargs):
    """``solve_many`` on the card; returns the result and the wall time,
    ended by a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = st.solve_many(torch_device=CARD, **kwargs)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def _sweep_stream_error(result, reference, points=None):
    """Largest relative stream difference over the films, at all sweep
    points or at the pairs ``(index in result, index in reference)``."""
    worst = 0.0
    for name, b in reference.streams.items():
        a = result.streams[name].astype(np.float64)
        b = b.astype(np.float64)
        for i, j in points or [(k, k) for k in range(len(b))]:
            worst = max(worst, float(np.abs(a[i] - b[j]).max() / np.abs(b[j]).max()))
    return worst


def _check_sweep_residuals(torch, model, result, label, film_data=None, circulating=None):
    """Prints each film's largest final relative residual over the sweep
    points, which must be at most RESIDUAL_MAX.  ``film_data`` carries the
    per-point transport offsets and vortex amplitudes of the sweep (default:
    the model's own), ``circulating`` the per-point circulating currents
    (default: the model's)."""
    from superscreen_tpu_torch.solver.utils import field_conversion_factor
    from superscreen_tpu_torch.sweep import relative_residual, vortex_flux_quantum

    device = model.device
    conv = field_conversion_factor(
        result.field_units, result.current_units, length_units=device.length_units,
        ureg=device.ureg,
    ).magnitude
    B = len(result)
    for name in device.films:
        data = (film_data or model.film_data)[name]
        dtype = data.weights.dtype
        Hz = result.applied_fields[name]
        if result.other_fields is not None:
            Hz = Hz + result.other_fields[name]
        I_circ = [
            [c.get(h, 0.0) for h in data.hole_names]
            for c in (circulating or [model.circulating_currents] * B)
        ]
        res = relative_residual(
            data,
            torch.as_tensor(Hz * conv, dtype=dtype, device=CARD),
            torch.as_tensor(I_circ, dtype=dtype, device=CARD).reshape(B, len(data.hole_names)),
            torch.as_tensor(result.streams[name], dtype=dtype, device=CARD),
            vortex_flux_quantum(device, result.current_units),
        )
        worst = float(res.max())
        print(
            f"{label} {name}: largest final relative residual over {B} points "
            f"{worst:.3e} (limit {RESIDUAL_MAX})"
        )
        _require(np.isfinite(worst) and worst <= RESIDUAL_MAX, f"{name} residual {worst:.3e}")


def phase_sweep(torch, st, cuda_kernels, model, lu_solutions):
    """The B-point sweep at full width on phase 4's model (the uncut
    27,000-site stack, low-memory LU, float32): eight fields, ITERATIONS
    coupling rounds.  Returns the launch counts of one sweep."""
    fields = [st.sources.ConstantField(v) for v in SWEEP_FIELDS]
    B = len(fields)
    kwargs = dict(model=model, applied_fields=fields, iterations=ITERATIONS)
    n_films = len(model.device.films)
    pairs = n_films * (n_films - 1) // 2
    _reset_launches(cuda_kernels)
    result, cold_s = _sweep(torch, st, **kwargs)
    launches = dict(cuda_kernels.LAUNCHES)
    print(f"phase7 launches of one sweep (B={B}, iterations={ITERATIONS}): {launches}")
    _require(len(result) == B and set(result.streams) == set(model.device.films))
    for arrays in (result.streams, result.current_densities, result.self_fields,
                   result.other_fields, result.applied_fields):
        _require(all(np.all(np.isfinite(a)) for a in arrays.values()), "non-finite sweep output")
    _require(launches["biot_savart_batch"] == 2 * pairs * ITERATIONS, launches)
    _require(launches["q_apply"] == n_films and launches["biot_savart_pair"] == 0, launches)
    _check_sweep_residuals(torch, model, result, "phase7")
    # Point 7 is phase 4's drive (field 1.0 with the model's circulating
    # current).  solve() at B = 1 forms its refinement residual in float32,
    # which leaves its streams up to ~9e-5 from a float64 solve; the sweep
    # accumulates its residuals in float64 (ops.linalg.system_residual).
    # So the sweep is held to a solve() that does the same, and its
    # distance to phase 4's float32-residual solve() to twice the limit.
    # Without circulating currents the problem is linear in the field.
    with _f64_residuals_from(1):
        reference = _solve(torch, st, model)[0][-1]

    def distance(swept, solution):
        return max(
            float(np.abs(swept.streams[name][B - 1] - fs.stream).max() / np.abs(fs.stream).max())
            for name, fs in solution.film_solutions.items()
        )

    def against_solve_and_linearity(label):
        swept, _ = _sweep(torch, st, **kwargs)
        err_solve, err_phase4 = distance(swept, reference), distance(swept, lu_solutions[-1])
        linear, _ = _sweep(torch, st, circulating_currents=[{}] * B, **kwargs)
        ratio = SWEEP_FIELDS[0] / SWEEP_FIELDS[-1]
        err_linear = max(
            float(np.abs(s[0] - s[B - 1] * ratio).max() / np.abs(s[B - 1] * ratio).max())
            for s in linear.streams.values()
        )
        print(
            f"phase7 {label}: point {B - 1} against solve() with float64 residuals "
            f"{err_solve:.3e}, against phase 4's solve() {err_phase4:.3e} (limit "
            f"{2 * STREAM_REL_MAX:.0e}), point 0 against point {B - 1} / 10 without circulating "
            f"currents {err_linear:.3e} (limits {STREAM_REL_MAX:.0e})"
        )
        _require(err_solve <= STREAM_REL_MAX, f"sweep against solve() {err_solve:.3e}")
        _require(err_phase4 <= 2 * STREAM_REL_MAX, f"sweep against phase 4 {err_phase4:.3e}")
        _require(err_linear <= STREAM_REL_MAX, f"sweep linearity {err_linear:.3e}")

    against_solve_and_linearity("inner rounds unrefined (default)")
    with _environ(SUPERSCREEN_TPU_INNER_REFINE="2"):
        against_solve_and_linearity("SUPERSCREEN_TPU_INNER_REFINE=2")
    # What the float64 accumulation of the residuals buys and costs: the
    # same sweep with float32 GEMM residuals, whose refinement follows the
    # product's rounding noise.  Printed, not held to a limit.
    with _f64_residuals_from(B + 1):
        _sweep(torch, st, **kwargs)
        noisy, noisy_s = _sweep(torch, st, **kwargs)
    print(
        f"phase7 with float32 GEMM residuals: point {B - 1} against solve() with float64 "
        f"residuals {distance(noisy, reference):.3e}, warm sweep {noisy_s:.4f} s"
    )
    with _pair_coupling(True):
        _reset_launches(cuda_kernels)
        paired, _ = _sweep(torch, st, **kwargs)
        pair_launches = dict(cuda_kernels.LAUNCHES)
    err_pair = _sweep_stream_error(paired, result)
    print(
        f"phase7 pair-coupled sweep: launches {pair_launches}; max relative stream difference "
        f"to the two-pass sweep {err_pair:.3e} (limit {PAIR_STREAM_REL_MAX:.0e})"
    )
    _require(pair_launches["biot_savart_pair"] == pairs * ITERATIONS, pair_launches)
    _require(pair_launches["biot_savart_batch"] == 0, pair_launches)
    _require(err_pair <= PAIR_STREAM_REL_MAX, f"pair sweep difference {err_pair:.3e}")
    # Warm times: the default sweep and the fully refined one in turns,
    # beside the warm B = 1 solve.
    times = {"0": [], "2": []}
    for steps in ("0", "2", "2", "0") * 2:
        with _environ(SUPERSCREEN_TPU_INNER_REFINE=steps):
            times[steps].append(_sweep(torch, st, **kwargs)[1])
    warm_s, refined_s = (sum(times[k]) / len(times[k]) for k in ("0", "2"))
    solve_s = min(_solve(torch, st, model)[1] for _ in range(3))
    print(
        f"phase7 solve_many wall: cold_s={cold_s:.4f} warm_s={warm_s:.4f} "
        f"{[round(t, 4) for t in times['0']]}; with SUPERSCREEN_TPU_INNER_REFINE=2 in turns "
        f"{refined_s:.4f} {[round(t, 4) for t in times['2']]} ({refined_s / warm_s:.2f}x)"
    )
    print(
        f"phase7 per sweep point {warm_s / B * 1e3:.2f} ms; warm B=1 solve() {solve_s * 1e3:.2f} ms, "
        f"so {B} solves {B * solve_s * 1e3:.1f} ms ({B * solve_s / warm_s:.2f}x the sweep)"
    )
    _profile(torch, lambda: _sweep(torch, st, **kwargs)[1], "phase7 profile of the warm sweep")
    # The sweep's self-field: Q_apply over the B streams plus the row-sum
    # column, on all sites of a film.
    _time_q_apply(
        torch, "phase7 self-field shape", next(iter(model.device.meshes.values())).sites, B + 1
    )
    return launches


def _weak_spot(x, y, x0=0.0, y0=0.0, sigma=2.0, depth=0.5, base=1.0):
    """A penetration depth ``base`` with a Gaussian weak spot (Lambda
    larger by the fraction ``depth`` at its centre)."""
    return base * (1 + depth * np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2)))


def transport_stack(st, sites_strip, sites_ring, solve_dtype="float32"):
    """Phase 8's device: a 20 x 8 strip at z0 = 0 with a hole, a source and
    a drain terminal on its short edges and a Gaussian weak spot in Lambda,
    under a ring (radius 7, hole of radius 3) at z0 = 1 whose Lambda has a
    weak spot too.  A film with terminals keeps its boundary as given, so
    the strip's outline and its hole are drawn at the mesh's edge length."""
    width, height = 20.0, 8.0
    h = np.sqrt(2 * width * height / (np.sqrt(3) * sites_strip))
    layers = [
        st.Layer("base", Lambda=st.Parameter(_weak_spot, x0=2.0, y0=1.0), z0=0),
        st.Layer("top", Lambda=st.Parameter(_weak_spot, x0=-3.0, y0=4.0, base=0.5), z0=1),
    ]
    films = [
        st.Polygon(
            "strip", layer="base",
            points=st.geometry.box(width, height, points=int(2 * (width + height) / h)),
        ),
        st.Polygon("ring", layer="top", points=st.geometry.circle(7.0, points=60)),
    ]
    holes = [
        st.Polygon(
            "strip_hole", layer="base",
            points=st.geometry.circle(1.5, points=int(2 * np.pi * 1.5 / h), center=(-5.0, 0.0)),
        ),
        st.Polygon("ring_hole", layer="top", points=st.geometry.circle(3.0, points=30)),
    ]
    terminals = {
        "strip": [
            # Thinner than the boundary spacing: a terminal owns the
            # vertices of its short edge only.
            st.Polygon("source", points=st.geometry.box(h / 4, height, center=(-width / 2, 0))),
            st.Polygon("drain", points=st.geometry.box(h / 4, height, center=(width / 2, 0))),
        ]
    }
    device = st.Device(
        "transport_stack", layers=layers, films=films, holes=holes, terminals=terminals,
        solve_dtype=solve_dtype,
    )
    device.make_mesh(min_points={"strip": sites_strip, "ring": sites_ring})
    return device


def transport_sweep_kwargs(st, B=8):
    """The eight-point sweep of phase 8: the bias current from 1 to 8 uA,
    the two vortices' amplitudes through winding-number states, a hole
    current in the ring, in a uniform field of 0.1 mT."""
    rng = np.random.default_rng(8)
    return dict(
        applied_fields=[st.sources.ConstantField(0.1)] * B,
        terminal_currents=[
            {"strip": {"source": float(i), "drain": -float(i)}} for i in np.linspace(1.0, 8.0, B)
        ],
        circulating_currents=[{"ring_hole": 2.0 * b} for b in range(B)],
        vortex_nPhi0=rng.integers(-2, 3, (B, 2)).astype(float),
        iterations=TRANSPORT_ITERATIONS,
    )


TRANSPORT_VORTICES = [(3.0, 1.0), (6.0, -2.0)]


def _crossing_currents(solution):
    """The current through three cross-sections of the strip and the gross
    current ``int |J . n| dl`` crossing each.  The sections run 0.5 past
    both long edges (``J`` is zero outside the film), have 4,001 points
    (with 101 the quadrature error of the edge singularity of ``J`` is
    ~1.5e-2) and stay clear of the hole (x in [-6.5, -3.5]) and of the
    vortices (TRANSPORT_VORTICES)."""
    ys = np.linspace(-4.5, 4.5, 4001)
    out = []
    for x in (-8.25, -1.0, 8.25):
        path = np.stack([np.full_like(ys, x), ys], axis=1)
        crossing = solution.current_through_path(path, film="strip", with_units=False)
        J = solution.interp_current_density(0.5 * (path[:-1] + path[1:]), film="strip")
        out.append((abs(crossing), float(np.sum(np.abs(J[:, 0])) * (ys[1] - ys[0]))))
    return out


def _check_current_conservation(torch, st, model, result, sweep_kwargs):
    """Current conservation of the solve, by ``Solution.current_through_path``.

    With the transport drive alone (no applied field, no vortices, no hole
    current: the setting of the JAX package's transport benchmark) the
    current through every cross-section must equal the drive current within
    EDGE_CURRENT_TOL at all sweep points.  In the full sweep the screening
    currents of the field and of the vortices cross a section both ways at
    hundreds of times the drive and cancel in the integral, so the same
    integral is held to the gross current crossing the section instead."""
    drives = sweep_kwargs["terminal_currents"]
    B = len(drives)
    alone, _ = _sweep(
        torch, st, model=model, applied_fields=[st.sources.ConstantField(0)] * B,
        terminal_currents=drives, vortex_nPhi0=np.zeros((B, len(TRANSPORT_VORTICES))),
        iterations=TRANSPORT_ITERATIONS,
    )
    worst = worst_full = worst_gross = 0.0
    for b, drive in enumerate(drives):
        current = drive["strip"]["source"]
        for crossing, _ in _crossing_currents(alone.solution(b)):
            worst = max(worst, abs(crossing - current) / current)
        for crossing, gross in _crossing_currents(result.solution(b)):
            worst_full = max(worst_full, abs(crossing - current) / current)
            worst_gross = max(worst_gross, abs(crossing - current) / gross)
    print(
        f"phase8 strip, drive alone: current through 3 cross-sections against the drive current "
        f"at {B} sweep points, largest relative deviation {worst:.3e} (limit "
        f"{EDGE_CURRENT_TOL:.0e}; the JAX package's transport benchmark: "
        f"{JAX_CURRENT_CONSERVATION:.1e})"
    )
    print(
        f"phase8 strip, full sweep (field, vortices, hole currents): largest deviation "
        f"{worst_full:.3e} of the drive current, {worst_gross:.3e} of the gross current crossing "
        f"the section (limit {GROSS_CURRENT_TOL:.0e})"
    )
    _require(worst <= EDGE_CURRENT_TOL, f"current conservation {worst:.3e}")
    _require(worst_gross <= GROSS_CURRENT_TOL, f"current against the gross current {worst_gross:.3e}")


def _time_within_film(torch, kernels, cuda_kernels, data, B):
    """The in-film self-field of the terminal strip at the sweep's shape:
    biot_savart_batch with the triangle centroids as sources, against its
    plain version."""
    rng = np.random.default_rng(9)
    dtype = data.weights.dtype
    m, n = data.tri_centroids.shape[0], data.sites.shape[0]
    J = torch.as_tensor(rng.standard_normal((B, m, 2)), dtype=dtype, device=CARD)
    args = (data.tri_centroids, data.tri_areas, J, data.sites, 0.0)
    abs_err, rel = _check_against_plain(
        torch, "in-film self-field", dtype,
        kernels.biot_savart_within_film(data.sites, data.tri_centroids, data.tri_areas, J),
        kernels.biot_savart_plain(*args),
    )
    ms = _timed(torch, lambda: cuda_kernels.biot_savart_batch(*args), 10)
    plain_ms = _timed(torch, lambda: kernels.biot_savart_plain(*args), 3)
    bound = _bound("biot_savart_batch", dtype, n, m, B)
    print(
        f"phase8 in-film self-field (biot_savart_batch, {m} centroids -> {n} sites, B={B}, "
        f"dz2=0): max_abs_err={abs_err:.3e} rel_err={rel:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} {_bound_text(bound, ms)}"
    )


def phase_transport(torch, st, kernels, cuda_kernels):
    """Vortices, terminals and a position-dependent Lambda at real size;
    returns the launch counts of the sweep."""
    from superscreen_tpu_torch import sweep as sweep_module
    from superscreen_tpu_torch.solver.utils import MAX_DENSE_KERNEL_SIZE

    t0 = time.perf_counter()
    device = transport_stack(st, SITES_STRIP, SITES_RING)
    coarse = transport_stack(st, SITES_COARSE, SITES_COARSE)
    sizes = {name: len(mesh.sites) for name, mesh in device.meshes.items()}
    print(
        f"phase8 mesh sites per film: {sizes} (coarse copy: "
        f"{ {name: len(mesh.sites) for name, mesh in coarse.meshes.items()} }); "
        f"meshed in {time.perf_counter() - t0:.3f} s"
    )
    _require(sizes["strip"] <= MAX_DENSE_KERNEL_SIZE < sizes["ring"], sizes)
    vortices = [st.Vortex(x=x, y=y, film="strip") for x, y in TRANSPORT_VORTICES]
    sweep_kwargs = transport_sweep_kwargs(st)
    B = len(sweep_kwargs["applied_fields"])

    def factorize(dev, torch_device=CARD):
        return st.factorize_model(
            device=dev, current_units="uA", vortices=vortices, torch_device=torch_device
        )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(cuda_kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = factorize(device)
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    factor_launches = dict(cuda_kernels.LAUNCHES)
    _reset_launches(cuda_kernels)
    result, cold_s = _sweep(torch, st, model=model, **sweep_kwargs)
    launches = dict(cuda_kernels.LAUNCHES)
    warm_s = min(_sweep(torch, st, model=model, **sweep_kwargs)[1] for _ in range(2))
    print(
        f"phase8 times: factorize_s={t_factor:.3f} solve_many cold_s={cold_s:.4f} "
        f"warm_s={warm_s:.4f} (B={B}, iterations={TRANSPORT_ITERATIONS}) "
        f"peak_memory_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}"
    )
    print(f"phase8 launches: factorize {factor_launches}, sweep {launches}")
    strip, ring = model.film_data["strip"], model.film_data["ring"]
    _require(strip.terminal and strip.Qw is None and strip.fac_kind == "lu", "strip route")
    _require(model.film_info["strip"].lambda_info.inhomogeneous, "strip Lambda")
    _require(ring.Qw is None and ring.fac_kind == "lu" and not ring.terminal, "ring route")
    _require(model.film_info["ring"].lambda_info.inhomogeneous, "ring Lambda")
    _require(strip.vortex_cols.shape == (len(strip.interior), 2), "vortex columns")
    # Per sweep: two coupling passes per round, the strip's in-film
    # self-field through biot_savart_batch, the ring's through q_apply.
    _require(launches["biot_savart_batch"] == 2 * TRANSPORT_ITERATIONS + 1, launches)
    _require(launches["q_apply"] == 1, launches)
    _require(factor_launches["q_matrix"] == 2 and factor_launches["q_apply"] >= 2, factor_launches)
    for arrays in (result.streams, result.current_densities, result.self_fields, result.other_fields):
        _require(all(np.all(np.isfinite(a)) for a in arrays.values()), "non-finite sweep output")
    film_data, _ = sweep_module._apply_vortex_amplitudes(
        model, model.film_data, sweep_kwargs["vortex_nPhi0"], B
    )
    film_data, _ = sweep_module._apply_terminal_sweeps(
        model, film_data, sweep_kwargs["terminal_currents"], B, "uA"
    )
    _check_sweep_residuals(
        torch, model, result, "phase8", film_data=film_data,
        circulating=sweep_kwargs["circulating_currents"],
    )
    _check_current_conservation(torch, st, model, result, sweep_kwargs)
    _time_within_film(torch, kernels, cuda_kernels, strip, B)
    _profile(
        torch, lambda: _sweep(torch, st, model=model, **sweep_kwargs)[1],
        "phase8 profile of the warm sweep",
    )
    del film_data, strip, ring
    # The comparisons below refine the inner rounds too, so that they see
    # the solvers and the dtypes, not the unrefined inner rounds' share
    # (phase 7 and the next line print how much that is).
    with _environ(SUPERSCREEN_TPU_INNER_REFINE="2"):
        _transport_comparisons(
            torch, st, cuda_kernels, factorize, sweep_kwargs, device, coarse, model, result
        )
    return launches


def _transport_comparisons(
    torch, st, cuda_kernels, factorize, sweep_kwargs, device, coarse, model, default_result
):
    """Phase 8's accuracy comparisons, with the inner rounds refined: the
    coarse copy in float32 on the card against float64 on the CPU, and the
    ring by matrix-free BiCGStab against LU."""
    from superscreen_tpu_torch.ops import linalg

    result, _ = _sweep(torch, st, model=model, **sweep_kwargs)
    print(
        f"phase8 default sweep (inner rounds unrefined) against the refined one: max relative "
        f"stream difference {_sweep_stream_error(default_result, result):.3e}"
    )
    coarse64 = coarse.copy()
    coarse64.solve_dtype = "float64"
    gpu, _ = _sweep(torch, st, model=factorize(coarse), **sweep_kwargs)
    cpu = st.solve_many(model=factorize(coarse64, "cpu"), torch_device="cpu", **sweep_kwargs)
    err = _sweep_stream_error(gpu, cpu)
    print(
        f"phase8 coarse copy, float32 on the card against float64 on the CPU: max relative "
        f"stream error {err:.3e} (limit {STREAM_REL_MAX:.0e})"
    )
    _require(err <= STREAM_REL_MAX, f"coarse stream error {err:.3e}")
    # The ring by matrix-free BiCGStab (its Lambda is inhomogeneous).
    del model
    torch.cuda.empty_cache()
    with _environ(SUPERSCREEN_TPU_LARGE_FACTOR="cg"):
        linalg.CG_STATS.update(solves=0, iterations=0, max_residual=0.0)
        _reset_launches(cuda_kernels)
        cg_model = factorize(device)
        cg_result, cg_s = _sweep(torch, st, model=cg_model, **sweep_kwargs)
        cg_launches = dict(cuda_kernels.LAUNCHES)
        stats = dict(linalg.CG_STATS)
        # Once more from the factorization on: the sparse products are in
        # gather form, so the run must repeat to the bit.
        linalg.CG_STATS.update(solves=0, iterations=0, max_residual=0.0)
        again, _ = _sweep(torch, st, model=factorize(device), **sweep_kwargs)
        again_iterations = linalg.CG_STATS["iterations"]
    same_bits = all(
        np.array_equal(cg_result.streams[name], again.streams[name]) for name in cg_result.streams
    )
    print(
        f"phase8 BiCGStab ring twice: {stats['iterations']} and {again_iterations} iterations, "
        f"streams bitwise equal: {same_bits}"
    )
    _require(again_iterations == stats["iterations"], "BiCGStab iteration counts differ")
    _require(same_bits, "two BiCGStab runs differ")
    del again
    _require(cg_model.film_data["ring"].fac_kind == "bicgstab", "ring not on the BiCGStab route")
    _require(cg_model.film_data["ring"].A is None, "ring system materialized")
    _require(cg_model.film_data["strip"].fac_kind == "lu", "terminal strip must keep its LU")
    # Two matvecs per BiCGStab iteration.
    _require(cg_launches["q_apply"] >= 2 * stats["iterations"], cg_launches)
    err = _sweep_stream_error(cg_result, result)
    print(
        f"phase8 BiCGStab ring: {stats['solves']} solves, {stats['iterations']} iterations, "
        f"largest final recurrence residual {stats['max_residual']:.3e}, cold sweep "
        f"{cg_s:.3f} s, launches {cg_launches}; max relative stream difference to "
        f"LU {err:.3e} (limit {CG_STREAM_REL_MAX:.0e})"
    )
    _require(err <= CG_STREAM_REL_MAX, f"BiCGStab stream difference {err:.3e}")


def _wall(torch, fn):
    """``fn()`` and its wall time in seconds, ended by a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _field_map_kernel_row(torch, kernels, cuda_kernels, solution, grid, name):
    """The sum behind one film's part of the field map (biot_savart_batch,
    the film's sites -> the map's points, B = 1) against the blocked plain
    version on the card, timed beside its bound."""
    mesh = solution.device.meshes[name]
    layer = solution.device.layers[solution.device.films[name].layer]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=CARD)

    n, m = len(mesh.sites), len(grid)
    positions = t(np.column_stack([mesh.sites, np.full(n, layer.z0)]))
    targets = t(np.column_stack([grid, np.full(m, MAP_HEIGHT)]))
    J, areas = t(solution.film_solutions[name].current_density), t(mesh.vertex_areas)
    before = cuda_kernels.LAUNCHES["biot_savart_batch"]
    out = kernels.biot_savart_2d_field(targets, positions, J, areas, vector=False)
    _require(cuda_kernels.LAUNCHES["biot_savart_batch"] == before + 1, "field map not on the kernel")
    abs_err, rel = _check_against_plain(
        torch, f"field map {name}", torch.float32, out,
        kernels.biot_savart_2d_field_plain(targets, positions, J, areas, vector=False),
    )
    ms = _timed(
        torch, lambda: kernels.biot_savart_2d_field(targets, positions, J, areas, vector=False), 10
    )
    plain_ms = _timed(
        torch,
        lambda: kernels.biot_savart_2d_field_plain(targets, positions, J, areas, vector=False), 3,
    )
    bound = _bound("biot_savart_batch", torch.float32, m, n, 1)
    print(
        f"phase9 field map of {name} (biot_savart_batch, {n} sites -> {m} points, B=1, "
        f"dz2={(MAP_HEIGHT - layer.z0) ** 2}): max_abs_err={abs_err:.3e} rel_err={rel:.3e} "
        f"(limit {TOL['float32']:.0e}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"{_bound_text(bound, ms)}"
    )


def _rel_to_max(a, b):
    """Largest difference relative to max|b|."""
    a = np.asarray(getattr(a, "magnitude", a), dtype=np.float64)
    b = np.asarray(getattr(b, "magnitude", b), dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_postprocess(torch, st, kernels, cuda_kernels, model, lu_solutions):
    """Post-processing at full width on phase 4's model (the uncut
    27,000-site stack, float32) and its solutions; returns the launch counts
    of the field map."""
    device = model.device
    solution = lu_solutions[-1]
    films = list(device.films)
    _require(solution.torch_device == model.torch_device, "solution not on the model's device")
    # The triangle indices: built on the host once per mesh, shared by
    # every solution of the device.
    t0 = time.perf_counter()
    for name in films:
        device.meshes[name].spatial_index(CARD)
    build_s = time.perf_counter() - t0
    index = device.meshes[films[0]].spatial_index(CARD)
    _require(solution.device.meshes[films[0]].spatial_index(CARD) is index, "index not shared")
    print(
        f"phase9 triangle indices of {len(films)} films "
        f"({ {name: len(device.meshes[name].elements) for name in films} } triangles): built in "
        f"{build_s:.3f} s; grid {index.grid_dims}, {index.cell_tris.shape[1]} candidates per cell, "
        f"{index.tri_verts.dtype}"
    )

    # 1. The field map: one biot_savart_batch launch per film.
    half = 1.1 * max(max(film.extents) for film in device.films.values()) / 2
    axis = np.linspace(-half, half, MAP_SIDE)
    grid = np.stack(np.meshgrid(axis, axis), axis=-1).reshape(-1, 2)
    spacing = axis[1] - axis[0]

    def field_map():
        return solution.field_at_position(grid, zs=MAP_HEIGHT, with_units=False)

    field_map()  # warm
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(cuda_kernels)
    Bz, map_s = _wall(torch, field_map)
    launches = dict(cuda_kernels.LAUNCHES)
    print(
        f"phase9 field_at_position on a {MAP_SIDE} x {MAP_SIDE} map at z = {MAP_HEIGHT} "
        f"(spacing {spacing:.4f}): {map_s * 1e3:.1f} ms warm, launches {launches}, "
        f"peak_memory_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}"
    )
    _require(Bz.shape == (len(grid),) and np.all(np.isfinite(Bz)), "field map output")
    _require(launches["biot_savart_batch"] >= len(films), launches)
    for name in films:
        _field_map_kernel_row(torch, kernels, cuda_kernels, solution, grid, name)
    _profile(torch, lambda: _wall(torch, field_map)[1], "phase9 profile of the field map")

    # 2. The vector field and the vector potential on the same map.
    def vector_map():
        return solution.screening_field_at_position(
            grid, zs=MAP_HEIGHT, vector=True, with_units=False
        )

    torch.cuda.reset_peak_memory_stats()
    _reset_launches(cuda_kernels)
    B3, vector_s = _wall(torch, vector_map)
    vector_peak = torch.cuda.max_memory_allocated() / 1e9
    _require(cuda_kernels.LAUNCHES["biot_savart_batch"] == 0, "vector field on the kernel")
    screening = solution.screening_field_at_position(grid, zs=MAP_HEIGHT, with_units=False)
    err_z = _rel_to_max(screening, B3[:, 2])
    torch.cuda.reset_peak_memory_stats()
    A, potential_s = _wall(
        torch,
        lambda: solution.vector_potential_at_position(grid, zs=MAP_HEIGHT, with_units=False),
    )
    potential_peak = torch.cuda.max_memory_allocated() / 1e9
    _require(B3.shape == (len(grid), 3) and A.shape == (len(grid), 3), "map shapes")
    _require(np.all(np.isfinite(B3)) and np.all(np.isfinite(A)), "non-finite map")
    # Bz = dAy/dx - dAx/dy by central differences on the grid's interior.
    Ax = A[:, 0].reshape(MAP_SIDE, MAP_SIDE).astype(np.float64)  # [y, x]
    Ay = A[:, 1].reshape(MAP_SIDE, MAP_SIDE).astype(np.float64)
    curl = (Ay[1:-1, 2:] - Ay[1:-1, :-2] - Ax[2:, 1:-1] + Ax[:-2, 1:-1]) / (2 * spacing)
    direct = B3[:, 2].reshape(MAP_SIDE, MAP_SIDE)[1:-1, 1:-1]
    err_curl = _rel_to_max(curl, direct)
    print(
        f"phase9 screening_field_at_position(vector=True) (plain route): {vector_s * 1e3:.1f} ms, "
        f"peak_memory_GB={vector_peak:.3f}; its z-component against the kernel route "
        f"{err_z:.3e} of its maximum (limit {TOL['float32']:.0e}); vector_potential_at_position: "
        f"{potential_s * 1e3:.1f} ms, peak_memory_GB={potential_peak:.3f}; Bz from the curl of A "
        f"against the summed Bz {err_curl:.3e} of its maximum (limit {CURL_TOL:.0e})"
    )
    _require(err_z <= TOL["float32"], f"vector z-component {err_z:.3e}")
    _require(err_curl <= CURL_TOL, f"curl of A {err_curl:.3e}")

    # 3. Interpolation at random points of the outer film.
    name = films[0]
    mesh = device.meshes[name]
    rng = np.random.default_rng(99)
    radius = 0.999 * max(device.films[name].extents) / 2 * np.sqrt(rng.uniform(0, 1, INTERP_POINTS))
    angle = rng.uniform(0, 2 * np.pi, INTERP_POINTS)
    pts = np.stack([radius * np.cos(angle), radius * np.sin(angle)], axis=1)
    _require(bool(device.films[name].contains_points(pts).all()), "query outside the film")
    fs = solution.film_solutions[name]
    for method in ("linear", "cubic"):
        (J, field), interp_s = _wall(
            torch,
            lambda: (
                solution._interpolate(name, fs.current_density, pts, method),
                solution.interp_field(pts, film=name, method=method),
            ),
        )
        lost = int(np.isnan(field).sum() + np.isnan(J).any(axis=1).sum())
        print(
            f"phase9 {method} interpolation of J and the field at {INTERP_POINTS} points of "
            f"{name}: {interp_s * 1e3:.1f} ms, {lost} queries not found (limit 0)"
        )
        _require(lost == 0, f"{lost} interpolation queries not found")
        _require(J.dtype == fs.current_density.dtype, "interpolated dtype")
    at_sites = solution.interp_field(mesh.sites, film=name, dataset="self_field")
    err_sites = _rel_to_max(at_sites, fs.self_field)
    print(
        f"phase9 linear interpolant at the {len(mesh.sites)} mesh sites against the site values: "
        f"{err_sites:.3e} of their maximum (limit {SITE_VALUE_TOL:.0e})"
    )
    _require(err_sites <= SITE_VALUE_TOL, f"interpolant at sites {err_sites:.3e}")

    # 4. Fluxoids and fluxes of the zero-current solutions in a uniform
    # field: linear in the field, and the same from the card and the CPU.
    B = len(SWEEP_FIELDS)
    swept, _ = _sweep(
        torch, st, model=model, applied_fields=[st.sources.ConstantField(v) for v in SWEEP_FIELDS],
        circulating_currents=[{}] * B, iterations=ITERATIONS,
    )
    weak, strong = swept.solution(0), swept.solution(B - 1)
    _require(weak.device.meshes[name] is mesh, "sweep solutions do not share the mesh")
    on_cpu = st.Solution(
        device=device, film_solutions=strong.film_solutions,
        applied_field_func=strong.applied_field_func, field_units=strong.field_units,
        current_units=strong.current_units, torch_device="cpu",
    )
    ratio = SWEEP_FIELDS[-1] / SWEEP_FIELDS[0]
    worst_linear = worst_cpu = 0.0
    holes = list(device.holes)
    for hole in holes:
        fluxoid, fluxoid_s = _wall(torch, lambda: strong.hole_fluxoid(hole))
        total = sum(fluxoid).to("Phi_0").magnitude
        flux = strong.polygon_flux(hole, units="Phi_0", with_units=False)
        small = sum(weak.hole_fluxoid(hole)).to("Phi_0").magnitude
        cpu_total = sum(on_cpu.hole_fluxoid(hole)).to("Phi_0").magnitude
        worst_linear = max(worst_linear, abs(small * ratio - total) / abs(total))
        worst_cpu = max(worst_cpu, abs(cpu_total - total) / abs(total))
        print(
            f"phase9 {hole} at {SWEEP_FIELDS[-1]} mT without circulating currents: fluxoid "
            f"{total:.6f} Phi_0 (flux part {fluxoid.flux_part.magnitude:.6f}, supercurrent part "
            f"{fluxoid.supercurrent_part.magnitude:.6f}), flux through the hole {flux:.6f} Phi_0, "
            f"{fluxoid_s * 1e3:.1f} ms"
        )
        _require(np.isfinite(total) and np.isfinite(flux), f"{hole} fluxoid")
    print(
        f"phase9 fluxoids: point {B - 1} against {ratio:.0f} x point 0 {worst_linear:.3e} (limit "
        f"{FLUXOID_TOL:.0e}); interpolated on the card against on the CPU {worst_cpu:.3e} "
        f"(limit {SITE_VALUE_TOL:.0e})"
    )
    _require(worst_linear <= FLUXOID_TOL, f"fluxoid linearity {worst_linear:.3e}")
    _require(worst_cpu <= SITE_VALUE_TOL, f"fluxoid card against CPU {worst_cpu:.3e}")
    _profile(
        torch, lambda: _wall(torch, lambda: strong.hole_fluxoid(holes[0]))[1],
        "phase9 profile of one hole fluxoid",
    )
    del swept, weak, strong, on_cpu

    # 5. The mutual-inductance matrix in float32 and in float64 on the card.
    matrices = {}
    for dtype in ("float32", "float64"):
        dev = device.copy()
        dev.solve_dtype = dtype
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(cuda_kernels)
        M, mutual_s = _wall(
            torch, lambda: dev.mutual_inductance_matrix(iterations=ITERATIONS, torch_device=CARD)
        )
        M = np.asarray(M.magnitude)
        matrices[dtype] = M
        asym = float(np.abs(M - M.T).max() / np.abs(M).max())
        print(
            f"phase9 mutual_inductance_matrix(iterations={ITERATIONS}) in {dtype}: {mutual_s:.3f} s "
            f"(factorization included), launches {dict(cuda_kernels.LAUNCHES)}, "
            f"peak_memory_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}, asymmetry "
            f"|M - M^T| / max|M| = {asym:.3e}; M in pH:"
        )
        for row in M:
            print("phase9   " + " ".join(f"{v:12.6f}" for v in row))
        _require(np.all(np.isfinite(M)) and np.all(np.diag(M) > 0), "mutual inductance matrix")
    err_m = _rel_to_max(matrices["float32"], matrices["float64"])
    print(
        f"phase9 mutual inductances, float32 against float64 on the card: {err_m:.3e} of max|M| "
        f"(limit {MUTUAL_F32_TOL:.0e}; the JAX package's Huber mutual after its float64 polish: "
        f"{JAX_MUTUAL_REL_ERR:.2e})"
    )
    _require(err_m <= MUTUAL_F32_TOL, f"mutual inductance f32 against f64 {err_m:.3e}")

    # 6. One flux quantum in the outer ring's hole, none in the others.
    targets = {holes[0]: 1}
    torch.cuda.empty_cache()
    found, fluxoid_s = _wall(
        torch,
        lambda: st.find_fluxoid_solution(
            model, targets, applied_field=st.sources.ConstantField(SWEEP_FIELDS[0]),
            iterations=ITERATIONS, torch_device=CARD,
        ),
    )
    reached = {h: float(sum(found.hole_fluxoid(h)).to("Phi_0").magnitude) for h in holes}
    worst = max(abs(reached[h] - targets.get(h, 0)) for h in holes)
    print(
        f"phase9 find_fluxoid_solution({targets}) at {SWEEP_FIELDS[0]} mT: {fluxoid_s:.3f} s; "
        f"circulating currents {({h: round(float(c), 4) for h, c in found.circulating_currents.items()})} "
        f"{found.current_units}; fluxoids reached {({h: round(v, 6) for h, v in reached.items()})} "
        f"Phi_0, largest deviation {worst:.3e} (limit {FLUXOID_TOL:.0e})"
    )
    _require(worst <= FLUXOID_TOL, f"fluxoid targets missed by {worst:.3e} Phi_0")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import superscreen_tpu_torch as st
    from superscreen_tpu_torch.ops import cuda_kernels, kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_kernels.load_library()
    build_s = time.perf_counter() - t0
    print(
        f"torch {torch.__version__} CUDA {torch.version.cuda} numpy {np.__version__}; "
        f"kernel build {build_s:.2f} s"
    )
    t0 = time.perf_counter()
    device = four_ring_stack(st, SITES_DENSE)
    large = four_ring_stack(st, SITES_LARGE)
    print(f"mesh of the two four-ring stacks: {time.perf_counter() - t0:.3f} s")
    rows = phase_kernels(torch, kernels, cuda_kernels, device)
    rows.update(phase_lowmem_kernels(torch, kernels, cuda_kernels, large))
    launches = phase_solve(torch, st, cuda_kernels, device)
    phase_accuracy(st)
    model, lu_solutions, lowmem_launches = phase_lowmem(torch, st, cuda_kernels, large)
    pair_launches = phase_pair(torch, st, cuda_kernels, model, lu_solutions)
    sweep_launches = phase_sweep(torch, st, cuda_kernels, model, lu_solutions)
    map_launches = phase_postprocess(torch, st, kernels, cuda_kernels, model, lu_solutions)
    del model
    phase_cg(torch, st, cuda_kernels, large, lu_solutions)
    del large, device
    transport_launches = phase_transport(torch, st, kernels, cuda_kernels)
    # The sweep paths must have gone through their kernels too.
    _require(
        all(sweep_launches[k] > 0 for k in ("biot_savart_batch", "q_apply")), sweep_launches
    )
    _require(
        all(transport_launches[k] > 0 for k in ("biot_savart_batch", "q_apply")),
        transport_launches,
    )
    _require(map_launches["biot_savart_batch"] > 0, map_launches)
    # Each kernel's launches on the path it serves: the dense solve (phase
    # 2), the low-memory solve (phase 4) and the pair-coupling solve
    # (phase 6).
    launches.update(q_apply=lowmem_launches["q_apply"], biot_savart_pair=pair_launches["biot_savart_pair"])
    sources = {
        "q_matrix": ("superscreen_tpu_torch/csrc/q_matrix.cu", "superscreen_tpu/ops/pallas_kernels.py:138"),
        "biot_savart_batch": (
            "superscreen_tpu_torch/csrc/biot_savart.cu",
            "superscreen_tpu/ops/pallas_kernels.py:201",
        ),
        "q_apply": ("superscreen_tpu_torch/csrc/q_apply.cu", "superscreen_tpu/ops/pallas_kernels.py:508"),
        "biot_savart_pair": (
            "superscreen_tpu_torch/csrc/biot_savart_pair.cu",
            "superscreen_tpu/ops/pallas_kernels.py:336",
        ),
    }
    summary = [
        dict(
            name=name,
            route="cuda",
            source=sources[name][0],
            replaces=sources[name][1],
            launches=launches[name],
            **rows[name],
        )
        for name in sources
    ]
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

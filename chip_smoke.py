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
   MAX_DENSE_KERNEL_SIZE, factorized (materialized interior systems; above
   LU_MAX_N_TPU = 12,288 unknowns on the card every film of phases 2 to 17
   takes SUPERSCREEN_TPU_LARGE_FACTOR's default route, the explicit
   inverse "inv"; phase 8's films, whose Lambda is inhomogeneous, are
   inverted from their LU, "inv" without weights) and solved with five coupling rounds in float32.  No film may hold a
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
   same drive and phase 4's within 1e-4 and, without circulating
   currents, point 0 must be point 7 divided by 10 within 1e-4, with the
   inner rounds unrefined (the default) and refined
   (SUPERSCREEN_TPU_INNER_REFINE=2); the pair-coupled sweep must match
   the two-pass one within 1e-5.  Prints the cold and warm wall time, a
   profile of the warm sweep, the time per sweep point beside 8 warm
   B = 1 solves, the warm sweep with
   SUPERSCREEN_TPU_INNER_REFINE=2 in turns with the default, and the
   warm B = 1 solve in turns with the float32 product that the
   residual_f64 kernel replaced in its refinement (time, and distance to
   the sweep).
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
   streams are within 1e-4 of its inverse's from LU, and a second factorization and sweep
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
   hole (targets met within 1e-3 Phi_0).  A warm hole fluxoid and the
   float32 matrix are timed again on the plain route of the ring test
   (SUPERSCREEN_TPU_NATIVE=0; the matrix within 1e-6 of the core's).
10. Float64 certification and polish on phase 4's model and phase 7's
   sweep: ``certify_sweep`` (the float64 residual per film and point; the
   device's residual against NumPy's on 512 sampled rows within 1e-12;
   the distance to the float64-refined streams), ``solve_many(final_refine
   =2)`` (residual after the polish at most 1e-7; the delivered float64
   streams, and the same sweep delivered in float32, certified again; the
   polish alone and the sweep with and without it timed; a profile),
   ``solve(high_precision=True)`` against a float64 model of the same
   stack on the card (streams within 1e-8; times and peak memory of both
   routes; float64 q_apply and biot_savart_batch timed at its shapes;
   ``check_inversion`` silent), the polished streams against the float64
   model's (within 1e-4: the float32 assembly remains).  Phase 8 repeats
   the certificate and the polish on its transport stack without vortices
   (the terminal strip with per-point transport offsets) and shows the
   strip with vortices skipped with a note.
11. The Huber susceptometer (``squids.mutuals``), meshed at its published
   edge length 0.4 with 100 smoothing steps: ``pickup_loop_mutual`` with
   terminals in float32, polished, at high precision and on a float64
   copy (float32 within 1e-3 and high precision within 1e-5 of float64;
   float64 within 1e-2 of the JAX package's 1.804621 pH), then the closed
   layout through ``mutual_inductance_matrix``.
12. The FFT inter-film coupling on phase 4's model: ``solve_many(coupling=
   "fft")`` with phase 7's fields and five rounds, its streams within 2e-2
   of each film's max|g| from phase 7's exact sweep (the JAX package's
   test bar) and its residuals at most 1e-4, then ``solve(coupling="fft")``
   at B = 1 against the sweep's point 7; one exact and one FFT round timed
   in turns and profiled; the same two rounds on pairs of disks of the
   shape of bench.py's payoff pair at ~12,000, ~30,000 and ~100,000 sites
   per film and on the Huber susceptometer (B = 8, seeded streams and
   currents); the constants of ``coupling="auto"``'s cost model fitted on
   all five (the FFT round's device work from the stack's profile), and
   each decision beside the measured faster mode (the package's must
   agree wherever one mode is more than 1.25x faster).
13. BASELINE config 5 (bench.py's scanning configuration, meshed by this
   package): a mini SQUID (~2,000 sites) over a 6 um disk (~8,000 sites),
   64 positions: the susceptibility scan in float32 (mirror symmetry
   within 1e-2; positions 16, 32, 48 within 1e-5 of the same scan on
   float64 copies of the meshes on the card), ``biot_savart_batch`` at the
   scan's two shapes against its plain version, ``back_action=1`` at 16
   positions, ``magnetometry_scan(screening=True)`` over a Pearl vortex;
   ``imaging.invert_field_map`` of a 192 x 192 map of a solved ring
   against its stream (the JAX package's test bars); and
   ``vortex_energy_landscape`` on a ~15,000-site disk, the self-energy at
   one site within 1e-5 of a vortex solve there.
14. The differentiable solve, last, where no other model holds the card:
   ``build_adjoint_model`` on phase 2's stack (about 20,000 sites per
   film, five coupling rounds), its float32 forward pass within 1e-4 of
   phase 2's ``solve()`` and its float64 one within 1e-8 of a float64
   ``solve()`` on the card; the float32 gradient within 2e-4 of the
   float64 one; the directional derivative of the summed squared
   self-fields along a seeded direction in one film's Lambda within 1e-6
   of a central difference; two backward passes bitwise equal, and the
   backward pass launching biot_savart_batch; the coupling VJP on the
   kernel against plain autograd through biot_savart_plain (1e-5 in
   float32, 1e-12 in float64); q_matrix in float64 on the stack's and the
   sample's sites against q_matrix_plain (1e-12), and q_matrix and
   biot_savart_batch (forward and VJP shapes) timed beside their bounds.
   Then config 5 of phase 13 with a hidden Gaussian weak spot in the
   sample's Lambda: ``build_scan_forward`` within 1e-8 (float64) and
   1e-4 (float32) of ``susceptibility_scan``, the gradient of a map
   misfit within 1e-6 of a central difference, and five Adam steps from a
   uniform guess, whose misfit must fall.  Forward, backward and step
   times, launches, peak memory and profiles are printed.
15. The host conveniences on phase 2's stack: ``distance.q_matrix`` on
   one film's ~20,000 sites (NumPy out) bitwise equal to the q_matrix
   kernel route, with one launch; ``translate(3, -2)``, which keeps and
   shifts the mesh, factorized and solved (streams within 1e-4 of phase
   2's, relative to each film's max|g|; the same error printed for a shift
   of (50, 50) um, with no bar); with ``SUPERSCREEN_TPU_MESH_CACHE`` set to
   a fresh temporary directory, the stack re-meshed (a miss, stored) and
   ``mirror_layers()`` meshed with the same parameters (a hit, identical
   arrays; both times printed), the mirrored stack solved (streams within
   1e-6 of phase 2's: the coupling depends on dz^2 only; bitwise equality
   printed); ``rotate(90)`` re-meshed and solved (each hole fluxoid
   within 1e-2 of phase 2's); ``solve(return_solutions=False,
   progress_bar=True)`` returning None (the card's machine has tqdm, so
   a bar shows there; the path without tqdm is held on the CPU by
   ``tests/test_torch_io.py``); ``distance.cdist`` and
   ``MeshOperators.C_vector`` on the card against the CPU (1e-12);
   ``version_dict()``; and, where h5py and dill are installed, an HDF5
   round trip of the rotated model (bitwise-equal streams) and of one
   solution (the card's machine has dill but no h5py: the phase says so on
   one line).
16. The geometry core and ``solve_film``: the core compiled once more from
   its source (the compiler's ``--version`` and the seconds printed);
   phase 2's stack re-meshed by the core (bit for bit phase 2's meshes;
   timed, and under cProfile with its five most expensive entries) and
   by the plain routes with SUPERSCREEN_TPU_NATIVE=0 (the same sites and
   triangle sets); the core's ring test on 10^6 points around a
   20,000-vertex outline against the NumPy loop, bit for bit on the first
   20,000 points and on every vertex and edge point, both timed;
   ``make_mesh(min_angle=30, extra_points=...)`` through the mesh cache
   (a miss, then a hit with identical arrays) and ``fem.in_polygon(...,
   radius=0.01)``; then ``solver.solve_film.solve_film`` against the last
   round of a ``solve()`` of the same drive, fed that round's field from
   the other films: every film of phase 2's stack with its dense kernel,
   the terminal strip of phase 8 with a hole current and two vortices
   (its self-field through biot_savart_batch), one low-memory film of
   phase 4's stack (through q_apply), all within 1e-5 of max|.| in stream
   and self-field; one call with ``check_inversion=True`` (its warnings
   printed); and one with ``hp_system`` against a float64 ``solve()`` on
   the card within 1e-8.  Launches and CUDA-event milliseconds per call;
   phase 9's post-processing times on both ring-test routes.
17. The multi-device layer (``superscreen_tpu_torch.parallel``) on a mesh
   of distinct cards where the machine has several, else of ``cuda:0``
   repeated (every split, per-shard launch, gather and row-sharded product
   runs; only copies between cards do not): ``solve_many(sharding=...)``
   over two data rows on phase 7's sweep (streams within 1e-5 of phase
   7's, residuals at most 1e-4, twice the unsharded sweep's launches,
   wall times in turns); ``sharded_film_data`` on a 2 x 2 mesh of phase
   2's dense stack (``_run_sweep`` within 1e-5 of the unsharded one,
   padded sites exactly 0, each ``Qw`` block's ``residual_f64`` route);
   ``sharded_biot_savart`` and ``sharded_self_field`` at the 27k stack's
   shapes, B = 8, on 2 x 2 (within 1e-6 and 1e-5 of the unsharded
   kernels, one launch per block; each beside a float64 evaluation); ``sharded_spd_inverse("schur")`` of one low-memory
   film over two slots (``(-A)(M h) = h`` within 1e-3 before refinement;
   its time and the largest tensor a slot held); a factorization mesh of
   two slots with ``SUPERSCREEN_TPU_MAX_MATERIALIZED_N`` at 0.8 x the
   smallest interior of phase 4's stack (every film ``"inv"``, ``A`` and
   ``M`` in row blocks, ``solve()`` within 1e-4 of phase 4's); and config
   5 over two data rows against phase 13's scan (1e-5).
18. The large-film factorization routes in turns on phase 2's dense stack
   and phase 4's 27k stack: "inv", "chol", "schur", "schulz" and LU (LU
   reached by raising LU_MAX_N_TPU inside the phase).  For each route the
   factorize wall time and the most (ni, ni) buffers one film's
   factorization held at once (at most 3 for "inv" and "chol", 4 for
   "schur" and "schulz": the budgets of their materialized ceilings), the
   warm B = 1 ``solve()``, ``solve_many`` at B = 8 with five rounds per
   point, the solve()'s streams within 1e-6 of LU's (of each film's
   max|g|), the sweep's distance to LU's sweep and the default sweep
   against SUPERSCREEN_TPU_INNER_REFINE=2 printed, and every film's final
   residual at most 1e-4; a torch.profiler table of the default route's
   warm sweep and solve with the triangular-solve kernels that remain.

Phases 2-11, 15 and 16 hold ``coupling="auto"`` to the exact pairwise coupling
(SUPERSCREEN_TPU_FFT_COUPLING_MIN_N set beyond any mesh): they measure the
exact coupling kernels, which the card's cost model may trade for the FFT
transfer at their sizes.  Phase 12 drives the FFT coupling.

Phase 1 also runs residual_f64 (R = H + A X, a float32 A with float64
right-hand sides and sums) against its plain version at 16,768 unknowns
with 1, 4 and 8 columns, on a rectangular block, at 20,274 unknowns with
6 columns, 6,715 with 64 and 15,000 with 2,048 (one launch per call at
every k), twice for bitwise equality, beside the widened route and the
float32 addmm (and cuBLAS DGEMM on a pre-widened A at k = 2,048); it runs q_apply, biot_savart_batch and biot_savart_pair against
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
# The interior unknowns of one film of the 27,000-site stack (16,766 to
# 16,772), rounded: the size of residual_f64's system in phases 4 to 10.
RESIDUAL_N = 16768
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
# Phase 10.  The device's float64 residual against NumPy's on sampled rows
# (the JAX package's test bar); the residual after the float64 polish (the
# JAX package delivers 2.12e-8 on its own device and mesh); the delivered
# float64 streams certified again with fields that went through float32
# field units; high_precision streams against the float64 model's (the JAX
# test's bar is 1e-9 at a few hundred sites); the polished streams against
# the float64 model's: the polish solves the float32 systems exactly, but
# those are assembled in float32 from float32 sites (a difference of two
# coordinates ~7 apart by ~0.1 keeps 5 digits, its cube fewer), so the
# streams stay in the float32 class of STREAM_REL_MAX (measured 4.8e-5 at
# 27,298 sites per film, 1e-6 at 500).
SAMPLED_ROW_TOL = 1e-12
POLISHED_RESIDUAL_MAX = 1e-7
RECERTIFIED_RESIDUAL_MAX = 1e-6
JAX_POLISHED_RESIDUAL = 2.12e-8
HP_STREAM_REL_MAX = 1e-8
POLISHED_STREAM_REL_MAX = STREAM_REL_MAX
# Phase 11: the high-precision mutual against the card's float64, and the
# port's float64 Huber mutual against the JAX package's figure (1.804621
# pH on its own mesher's triangles).
HP_MUTUAL_TOL = 1e-5
JAX_HUBER_MUTUAL_PH = 1.804621
JAX_HUBER_TOL = 1e-2
# Phase 12: FFT against exact streams (the JAX package's own test bar,
# tests/test_solve_coupling.py).
FFT_STREAM_REL_MAX = 2e-2
# The pairs of disks the coupling rounds are timed on (sites per film; the
# largest is bench.py's fft_coupling_payoff), and their batch.  Where one
# coupling mode is more than AUTO_TIE times faster, coupling="auto" must
# pick it.
SITES_PAIRS = (12000, 30000, 100000)
PAYOFF_B = 8
AUTO_TIE = 1.25
# The JAX package's cost-model constants (superscreen_tpu/sweep.py:1232-
# 1244, fitted on a TPU v5e), for the decision it would take here.
JAX_COST_MODEL = (9.0e-9, 2.0e-6, 8.0e-5)
# Phase 13: BASELINE config 5 (bench.py _scanning_config): 64 positions on
# linspace(-8, 8), height 1.0; the mirror-symmetry and float32-against-
# float64 bars and the JAX package's figures beside them (BENCH_DETAIL_r05
# scanning_sweep, its own mesher); the back-action batch, the imaging map,
# the landscape film and its self-energy bar.
SCAN_B = 64
SCAN_SQUID_POINTS = 2000
SCAN_SAMPLE_POINTS = 8000
SCAN_CHECK = (16, 32, 48)
MIRROR_MAX = 1e-2
JAX_MIRROR = 1.165e-3
SCAN_F64_MAX = 1e-5
JAX_SCAN_F64 = 1.044e-6
BACK_ACTION_B = 16
IMAGING_SIDE = 192
LANDSCAPE_POINTS = 15000
LANDSCAPE_TOL = 1e-5
# The torch device of the sweep phases.
CARD = "cuda"

# Phase 14 (the differentiable solve).  The float32 forward pass against
# phase 2's solve() and the float64 one against a float64 solve() on the
# card; the directional derivative against a central difference (the bar
# of tests/test_adjoint.py); the coupling VJP on the kernel against plain
# autograd (TOL); the scan against susceptibility_scan.
ADJ_F32_MAX = 1e-4
ADJ_F64_MAX = 1e-8
ADJ_FD_MAX = 1e-6
ADJ_FD_EPS = 1e-5
# The float32 stack gradient against the float64 one on the same drive,
# relative to max|grad64|: 6.0e-5 on an H100, about three times the float32
# forward's distance from float64, as a product of two float32 fields is.
ADJ_GRAD32_MAX = 2e-4
ADJ_SCAN_MAX = {"float32": 1e-4, "float64": 1e-8}
ADAM_STEPS = 5
ADAM_LR = 5e-2
ADAM_GUESS = 0.5
# Phase 16: the ring test on a 20,000-vertex outline at 10^6 points (the
# NumPy loop on the first 20,000 of them and on every point of the
# outline: it takes ~6 ns per point and edge), and solve_film against
# solve()'s last round (float32, relative to max|.| of each quantity).
RING_TEST_VERTICES = 20000
RING_TEST_POINTS = 1000000
RING_TEST_PLAIN_POINTS = 20000
SOLVE_FILM_REL_MAX = 1e-5

# Peak rates of an H100 SXM at its 700 W limit (132 SMs at 1.98 GHz;
# NVIDIA's data sheet): HBM bytes, FP32 and FP64 operations outside the
# tensor cores (an FMA counts 2), FP64 operations on the tensor cores
# (DMMA), and reciprocal square roots on the special-function units (16
# per clock per SM).
H100_RATES = {
    "bytes": 3.35e12, "float32": 66.9e12, "float64": 33.5e12, "float64_tensor": 67e12,
    "rsqrt": 4.18e12,
}


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


def _residual_bound(m, n, k, x_size=8, h_size=8, r_size=8):
    """The least time in ms for one residual_f64 call, and what sets it:
    the float32 A (m, n), the X (n, k) and the H (m, k) read once and the
    R (m, k) written once over the HBM rate (element sizes in bytes; no H
    is 0), or the 2 m n k float64 operations over the FP64 tensor cores'
    rate (the fastest FP64 the card has; the stream route runs on the FP64
    units at half of it)."""
    times = {
        "bytes": (4 * m * n + x_size * n * k + (h_size + r_size) * m * k) / H100_RATES["bytes"],
        "float64_tensor": 2 * m * n * k / H100_RATES["float64_tensor"],
    }
    what = max(times, key=times.get)
    return times[what] * 1e3, what


# k at which residual_f64's operations (2 m n k) take as long as the bytes
# of A (4 m n): against the FP64 tensor cores and against the FP64 units.
RESIDUAL_CROSSOVER_K = {
    "float64_tensor": 2 * H100_RATES["float64_tensor"] / H100_RATES["bytes"],
    "float64": 2 * H100_RATES["float64"] / H100_RATES["bytes"],
}


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


def _residual_inputs(torch, m, n, k, seed):
    """A float32 system block and float64 right-hand sides on the card,
    standard normal, from ``seed`` (made on the card: 16,768^2 values)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((m, n), generator=gen, dtype=torch.float32, device="cuda")
    X = torch.randn((n, k), generator=gen, dtype=torch.float64, device="cuda")
    H = torch.randn((m, k), generator=gen, dtype=torch.float64, device="cuda")
    return A, X, H


# residual_f64's shapes (m, n, k) on the main paths: the solve's
# refinement (k = 1), the mutual-inductance sweep (4), solve_many, the
# polish and the certificate (8) on the 27k stack's interior systems
# (16,766-16,772 unknowns: rows 16-byte aligned at 16,768, the stream
# route's TMA, and 8 bytes off at 16,766, its windows); a
# rectangular block (the terminal bootstrap's route); a dense film's
# self-field at phase 2's 20,274 sites (k = 6: rows 8 mod 16 bytes apart);
# the adjoint scan's refinement at B = 64 on config 5's 6,715 interior
# unknowns; one block of 2,048 identity columns of phase 13's landscape.
RESIDUAL_SHAPES = [
    (RESIDUAL_N, RESIDUAL_N, 1), (RESIDUAL_N - 2, RESIDUAL_N - 2, 1), (RESIDUAL_N, RESIDUAL_N, 4),
    (RESIDUAL_N, RESIDUAL_N, 8),
    (RESIDUAL_N // 3 + 5, RESIDUAL_N, 11), (20274, 20274, 6), (6715, 6715, 64),
    (15000, 15000, 2048),
]


def phase_residual_kernel(torch, kernels, cuda_kernels):
    """residual_f64 (R = H + A X, A float32, the rest float64) against its
    plain version at RESIDUAL_SHAPES, one launch per call at every k.  Both
    are float64 sums of exact products in another order, so they agree to
    TOL["float64"]; two launches agree to the bit.  Beside the kernel's
    time: its plan (route, split-K, grid, blocks per SM), its bound, the
    widened blocked route (the plain version) and the float32
    ``h + A @ x``, which is no yardstick for the result (it rounds every
    product) but reads the same bytes; at k = 2,048 also cuBLAS DGEMM on a
    pre-widened float64 A, which leaves out the widening (not the same
    function: the card's FP64 GEMM rate).  Returns the kernel's row (k = 1)
    for the summary line."""
    row = None
    print(
        "phase1 residual_f64 crossover reckoned: the operations of the FP64 tensor cores "
        f"match the bytes of A at k = {RESIDUAL_CROSSOVER_K['float64_tensor']:.1f}, those of "
        f"the FP64 units at k = {RESIDUAL_CROSSOVER_K['float64']:.1f}; the plan takes the "
        f"tensor-core route from k = {cuda_kernels.RESIDUAL_MMA_MIN_K_ALIGNED} where every row "
        f"of A is 16-byte aligned (the stream route's TMA), from k = "
        f"{cuda_kernels.RESIDUAL_MMA_MIN_K} elsewhere"
    )
    for m, n, k in RESIDUAL_SHAPES:
        A, X, H = _residual_inputs(torch, m, n, k, seed=77 + k)
        before = cuda_kernels.LAUNCHES["residual_f64"]
        out = cuda_kernels.residual_f64(A, X, H)
        _require(cuda_kernels.LAUNCHES["residual_f64"] == before + 1, "one launch per call")
        abs_err, rel = _check_against_plain(
            torch, f"residual_f64 m={m} n={n} k={k}", torch.float64, out,
            kernels.residual_f64_plain(A, X, H),
        )
        del out
        _check_deterministic(
            torch, f"residual_f64 m={m} n={n} k={k}", lambda: cuda_kernels.residual_f64(A, X, H)
        )
        plan = cuda_kernels.residual_plan(
            m, n, k, torch.cuda.get_device_properties(0).multi_processor_count,
            cuda_kernels._rows_aligned(A),
        )
        blocks, smem = cuda_kernels.residual_occupancy(plan, X.dtype)
        wide = k > 100
        ms = _timed(torch, lambda: cuda_kernels.residual_f64(A, X, H), 3 if wide else 20)
        plain_ms = _timed(torch, lambda: kernels.residual_f64_plain(A, X, H), 1 if wide else 3)
        x32, h32 = X.float(), H.float()
        f32_ms = _timed(torch, lambda: torch.addmm(h32, A, x32), 3 if wide else 20)
        del x32, h32
        bound = _residual_bound(m, n, k)
        print(
            f"phase1 residual_f64 m={m} n={n} k={k}: max_abs_err={abs_err:.3e} rel_err={rel:.3e} "
            f"(limit {TOL['float64']:.0e}) kernel_ms={ms:.4f} (1 launch; route {plan.route}, "
            f"width {plan.width}, {plan.splits} splits of {plan.split_tiles} tiles, grid "
            f"{plan.grid}, {blocks} blocks/SM at {smem} B shared) "
            f"plain_ms={plain_ms:.4f} (row blocks widened, float64 addmm) "
            f"float32_addmm_ms={f32_ms:.4f} {_bound_text(bound, ms)}"
        )
        _require(blocks >= cuda_kernels._RESIDUAL_BLOCKS_PER_SM, f"residual_f64 occupancy {blocks}")
        if wide:
            # As the landscape calls it: lu_solve's column-major float32
            # solution, float32 H, the result rounded to float32.
            x32t, h32 = X.T.float().contiguous().T, H.float()
            caller_ms = _timed(
                torch, lambda: cuda_kernels.residual_f64(A, x32t, h32, out_dtype=torch.float32), 3
            )
            print(
                f"phase1 residual_f64 m={m} n={n} k={k} with the landscape's dtypes (column-major "
                f"float32 X, float32 H and R): kernel_ms={caller_ms:.4f}, "
                f"{2 * m * n * k / caller_ms / 1e9:.1f} TFLOP/s"
            )
            del x32t, h32
            A64 = A.double()
            dgemm_ms = _timed(torch, lambda: A64 @ X, 3)
            print(
                f"phase1 residual_f64 m={m} n={n} k={k}: torch.mm of a pre-widened float64 A "
                f"(cuBLAS DGEMM; not the same function: the widening is left out) "
                f"{dgemm_ms:.4f} ms, {2 * m * n * k / dgemm_ms / 1e9:.1f} TFLOP/s"
            )
            del A64
        if (m, n, k) == (RESIDUAL_N, RESIDUAL_N, 1):
            row = _row(abs_err, ms, plain_ms, bound)
        del A, X, H
        torch.cuda.empty_cache()
    return {"residual_f64": row}


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
        torch_device=CARD,
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
                torch.as_tensor(Hz[None], dtype=dtype, device=CARD),
                torch.as_tensor(I_circ, dtype=dtype, device=CARD),
                torch.as_tensor(fs.stream[None], dtype=dtype, device=CARD),
            )[0]
        )
        print(f"{label} {name}: final relative residual {res:.3e} (limit {limit})")
        _require(np.isfinite(res) and (limit is None or res <= limit), f"{name} residual {res:.3e}")


def _profile_solve(torch, st, model, label):
    """A warm ``solve`` of ``model`` under torch.profiler (see
    :func:`_profile`)."""
    _profile(torch, lambda: _solve(torch, st, model)[1], label)


def _profile(torch, run, label, top=8, watch=()):
    """``run`` (which returns its wall time, ended by a synchronise) once to
    warm up and once under torch.profiler: prints its wall time (profiled),
    the device time (the kernels' summed self time), the device's idle
    share of the wall, and the kernels that take the most device time, with
    their launch counts, and for each name in ``watch`` the device time and
    launches of the kernels whose name holds it.  Returns the device time
    in ms."""
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
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(
            f"{label}   {e.self_device_time_total / 1e3:9.3f} ms "
            f"({e.self_device_time_total / 1e3 / device_ms:6.1%}) x{e.count:<6d} {e.key[:90]}"
        )
    for name in watch:
        hits = [e for e in events if name in e.key.lower()]
        print(
            f"{label}   kernels named *{name}*: {len(hits)} kinds, "
            f"{sum(e.count for e in hits)} launches, "
            f"{sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms"
        )
    return device_ms


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
    returns the launch counts and the final round's streams."""
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
    # Every round of solve() refines: three residuals per film and round;
    # and each film's self-field over the six rounds is one float64-summed
    # product.
    _require(
        launches["residual_f64"] == 3 * len(device.films) * (ITERATIONS + 1) + len(device.films),
        launches,
    )
    _check_residuals(torch, model, solutions[-1], "phase2")
    streams = {name: fs.stream for name, fs in solutions[-1].film_solutions.items()}
    return launches, streams, solutions[-1]


def phase_lowmem(torch, st, cuda_kernels, device):
    """The low-memory path at real size: every film above
    MAX_DENSE_KERNEL_SIZE, materialized interior systems, the default
    large-film route ("inv").  Returns the model, its solutions and the
    launch counts."""
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
        _require(data.Qw is None and data.fac_kind == "inv", f"{name} not on the low-memory 'inv' path")
    _require(launches["q_apply"] >= 3 * len(device.films), launches)
    _require(launches["q_matrix"] >= len(device.films), launches)
    _require(launches["biot_savart_batch"] >= 12 * ITERATIONS, launches)
    _require(launches["residual_f64"] == 3 * len(device.films) * (ITERATIONS + 1), launches)
    _check_residuals(torch, model, solutions[-1], "phase4")
    # The shape of the CG matvec: the interior sites of the first film (the
    # q-block that brandt_matvec applies), k = 1.
    name = next(iter(device.films))
    _time_q_apply(
        torch, "phase4 CG-matvec shape",
        device.meshes[name].sites[model.film_systems[name].indices], 1,
    )
    _profile_solve(torch, st, model, "phase4 profile of the warm 'inv' solve")
    # The peak of one film's factorization, for the materialized ceiling:
    # LU holds A, the -A handed to lu_factor, the packed LU and the
    # solver's workspace; "inv" A, the buffer its inverse is built in and
    # panels.  Per ni^2.
    name = next(iter(device.films))
    A = model.film_systems[name].A
    w = model.film_info[name].weights[model.film_data[name].interior]
    ni = A.shape[0]
    for route, args in (("LU", (A,)), ("'inv'", (A, w))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        factors = linalg.factor_system(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base + A.numel() * A.element_size()
        del factors
        print(
            f"phase4 factor_system peak at ni={ni} by {route}: {peak / 1e9:.3f} GB, "
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
    # A float32 CG solve stops on its recurrence residual (1e-6), which
    # drifts from the true one; the correction solve on the float64
    # matrix-free residual (ops.linalg.matrix_free_solve_host) brings the
    # true residual under the bar of the LU films.
    _check_residuals(torch, model, solutions[-1], "phase5")
    err = _stream_error(solutions, lu_solutions)
    print(
        f"phase5 max relative stream difference to phase 4's 'inv' solve {err:.3e} "
        f"(limit {CG_STREAM_REL_MAX:.0e})"
    )
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


def _exact_coupling():
    """Inside the block ``coupling="auto"`` resolves to the exact pairwise
    coupling (the threshold override set beyond any mesh): phases 2-11
    measure and check the exact coupling kernels, which the card's cost
    model may not pick at their sizes."""
    return _environ(SUPERSCREEN_TPU_FFT_COUPLING_MIN_N=str(2**62))


@contextlib.contextmanager
def _float32_residuals():
    """Inside the block the refinement residual of a float32 system is the
    float32 product ``h + A @ x`` that ``residual_f64`` replaced (for
    comparisons in turns only)."""
    from superscreen_tpu_torch.ops import linalg

    previous = linalg.system_residual
    linalg.system_residual = lambda A, h, x: h + A @ x
    try:
        yield
    finally:
        linalg.system_residual = previous


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
    coupling rounds.  Returns the launch counts of one sweep and its
    result."""
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
    # Only the final round refines: one residual and two refinement steps
    # per film.
    _require(launches["residual_f64"] == 3 * n_films, launches)
    _check_sweep_residuals(torch, model, result, "phase7")
    # Point 7 is phase 4's drive (field 1.0 with the model's circulating
    # current).  solve() and the sweep both form their refinement residuals
    # in float64 (ops.linalg.system_residual, the residual_f64 kernel from
    # one column on), so the sweep is held to a fresh solve() and to phase
    # 4's alike.  Without circulating currents the problem is linear in the
    # field.
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
            f"phase7 {label}: point {B - 1} against solve() {err_solve:.3e}, against phase 4's "
            f"solve() {err_phase4:.3e}, point 0 against point {B - 1} / 10 without circulating "
            f"currents {err_linear:.3e} (limits {STREAM_REL_MAX:.0e})"
        )
        _require(err_solve <= STREAM_REL_MAX, f"sweep against solve() {err_solve:.3e}")
        _require(err_phase4 <= STREAM_REL_MAX, f"sweep against phase 4 {err_phase4:.3e}")
        _require(err_linear <= STREAM_REL_MAX, f"sweep linearity {err_linear:.3e}")

    # What the float64 residual of solve() buys and costs at B = 1: the same
    # warm solve with the float32 product it replaced, in turns.
    times = {False: [], True: []}
    for f32 in (True, False, False, True) * 2:
        with _float32_residuals() if f32 else contextlib.nullcontext():
            solutions, seconds = _solve(torch, st, model)
        times[f32].append(seconds)
        if f32:
            err_f32 = distance(result, solutions[-1])
    print(
        f"phase7 warm B=1 solve() in turns: float64 residuals (residual_f64) "
        f"{np.mean(times[False]):.4f} s {[round(t, 4) for t in times[False]]}, float32 product "
        f"{np.mean(times[True]):.4f} s {[round(t, 4) for t in times[True]]}; sweep point {B - 1} "
        f"against solve(): {distance(result, reference):.3e} with float64 residuals, "
        f"{err_f32:.3e} with the float32 product"
    )
    against_solve_and_linearity("inner rounds unrefined (default)")
    with _environ(SUPERSCREEN_TPU_INNER_REFINE="2"):
        against_solve_and_linearity("SUPERSCREEN_TPU_INNER_REFINE=2")
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
    return launches, result


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
    returns the launch counts of the sweep and the meshed device."""
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
    # Inhomogeneous Lambda above LU_MAX_N_TPU: inverted from the LU.
    _require(strip.terminal and strip.Qw is None and strip.fac_kind == "inv", "strip route")
    _require(strip.factors[2] is None, "strip inverted from its LU")
    _require(model.film_info["strip"].lambda_info.inhomogeneous, "strip Lambda")
    _require(ring.Qw is None and ring.fac_kind == "inv" and not ring.terminal, "ring route")
    _require(ring.factors[2] is None, "ring inverted from its LU")
    _require(model.film_info["ring"].lambda_info.inhomogeneous, "ring Lambda")
    _require(strip.vortex_cols.shape == (len(strip.interior), 2), "vortex columns")
    # Per sweep: two coupling passes per round, the strip's in-film
    # self-field through biot_savart_batch, the ring's through q_apply.
    _require(launches["biot_savart_batch"] == 2 * TRANSPORT_ITERATIONS + 1, launches)
    _require(launches["q_apply"] == 1, launches)
    # The final round's refinement of both films, and the terminal
    # bootstrap's unit solutions of this call.
    _require(launches["residual_f64"] > 6, launches)
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
    _certify_transport(torch, st, cuda_kernels, device, model, sweep_kwargs)
    # The comparisons below refine the inner rounds too, so that they see
    # the solvers and the dtypes, not the unrefined inner rounds' share
    # (phase 7 and the next line print how much that is).
    with _environ(SUPERSCREEN_TPU_INNER_REFINE="2"):
        _transport_comparisons(
            torch, st, cuda_kernels, factorize, sweep_kwargs, device, coarse, model, result
        )
    return launches, device


def _transport_comparisons(
    torch, st, cuda_kernels, factorize, sweep_kwargs, device, coarse, model, default_result
):
    """Phase 8's accuracy comparisons, with the inner rounds refined: the
    coarse copy in float32 on the card against float64 on the CPU, and the
    ring by matrix-free BiCGStab against its inverse from LU."""
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
    _require(cg_model.film_data["strip"].fac_kind == "inv", "terminal strip must keep its inverse")
    # Two matvecs per BiCGStab iteration.
    _require(cg_launches["q_apply"] >= 2 * stats["iterations"], cg_launches)
    err = _sweep_stream_error(cg_result, result)
    print(
        f"phase8 BiCGStab ring: {stats['solves']} solves, {stats['iterations']} iterations, "
        f"largest final recurrence residual {stats['max_residual']:.3e}, cold sweep "
        f"{cg_s:.3f} s, launches {cg_launches}; max relative stream difference to "
        f"the inverse from LU {err:.3e} (limit {CG_STREAM_REL_MAX:.0e})"
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
    of the field map and the warm times of a hole fluxoid and of the
    float32 mutual-inductance matrix, with the geometry core's ring test
    and on the plain route (SUPERSCREEN_TPU_NATIVE=0)."""
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
    # One warm hole fluxoid with the core's ring test and on the plain
    # route, in turns.
    post_times = {"fluxoid": [], "fluxoid_plain": []}
    for key in ("fluxoid", "fluxoid_plain", "fluxoid_plain", "fluxoid"):
        with _environ(SUPERSCREEN_TPU_NATIVE="0" if key == "fluxoid_plain" else "1"):
            post_times[key].append(_wall(torch, lambda: strong.hole_fluxoid(holes[0]))[1])
    post_times = {key: min(values) for key, values in post_times.items()}
    print(
        f"phase9 warm hole fluxoid ({holes[0]}): {post_times['fluxoid']:.3f} s with the geometry "
        f"core, {post_times['fluxoid_plain']:.3f} s on the plain route (best of two, in turns)"
    )
    _profile(
        torch, lambda: _wall(torch, lambda: strong.hole_fluxoid(holes[0]))[1],
        "phase9 profile of one hole fluxoid",
    )
    del swept, weak, strong, on_cpu

    # 5. The mutual-inductance matrix in float32 and in float64 on the card,
    # and in float32 on the plain route of the ring test.
    matrices = {}
    for dtype in ("float32", "plain", "float64"):
        dev = device.copy()
        dev.solve_dtype = "float32" if dtype == "plain" else dtype
        if dtype == "plain":
            torch.cuda.empty_cache()
            with _environ(SUPERSCREEN_TPU_NATIVE="0"):
                M, post_times["mutual_plain"] = _wall(
                    torch,
                    lambda: dev.mutual_inductance_matrix(iterations=ITERATIONS, torch_device=CARD),
                )
            M = np.asarray(M.magnitude)
            err = _rel_to_max(M, matrices["float32"])
            print(
                f"phase9 mutual_inductance_matrix float32 on the plain route (SUPERSCREEN_TPU_"
                f"NATIVE=0): {post_times['mutual_plain']:.3f} s; against the core's "
                f"{err:.3e} of max|M| (limit 1e-6), bitwise equal {np.array_equal(M, matrices['float32'])}"
            )
            _require(err <= 1e-6, f"the plain ring test changed the mutual inductances {err:.3e}")
            continue
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(cuda_kernels)
        M, mutual_s = _wall(
            torch, lambda: dev.mutual_inductance_matrix(iterations=ITERATIONS, torch_device=CARD)
        )
        M = np.asarray(M.magnitude)
        matrices[dtype] = M
        if dtype == "float32":
            post_times["mutual"] = mutual_s
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
    return launches, post_times


def _certify_inputs(model, result, film_data=None, circulating=None):
    """What certify_sweep and refine_sweep_f64 take, rebuilt from a
    delivered SweepResult: the film data, and per film the streams, the
    field from the other films, the applied field and the circulating
    currents in solver units.  The fields come back through the result's
    field units and are cast to the solve dtype again, which recovers the
    values the sweep solved with (up to a last bit here and there)."""
    from superscreen_tpu_torch.solver.utils import field_conversion_factor

    device = model.device
    dtype = np.dtype(device.solve_dtype)
    conv = field_conversion_factor(
        result.field_units, result.current_units, length_units=device.length_units,
        ureg=device.ureg,
    ).magnitude
    B = len(result)
    film_data = film_data or model.film_data

    def solver_units(fields):
        return {
            name: (a.astype(np.float64) * conv).astype(dtype) for name, a in fields.items()
        }

    others = None if result.other_fields is None else solver_units(result.other_fields)
    I_circ = {
        name: np.array(
            [[c.get(h, 0.0) for h in data.hole_names]
             for c in (circulating or [model.circulating_currents] * B)],
            dtype=dtype,
        ).reshape(B, len(data.hole_names))
        for name, data in film_data.items()
    }
    return film_data, result.streams, others, solver_units(result.applied_fields), I_circ


def _print_certificate(label, report):
    for name, rel in report["residual_rel_per_film"].items():
        print(
            f"{label} {name}: float64 residual per point {rel}, "
            f"{report['film_seconds'][name]} s"
        )
    for name, note in report.get("films_skipped", {}).items():
        print(f"{label} {name}: skipped, {note}")
    print(
        f"{label}: residual_rel_max={report['residual_rel_max']:.3e} "
        f"sampled_row_rel_disagreement={report['sampled_row_rel_disagreement']:.3e} "
        f"(limit {SAMPLED_ROW_TOL:.0e}, {report['n_sample_rows']} rows) "
        f"refined_stream_delta_max={report['refined_stream_delta_max']:.3e} "
        f"refined_residual_rel_max={report['refined_residual_rel_max']:.3e}"
    )
    _require(
        report["sampled_row_rel_disagreement"] < SAMPLED_ROW_TOL,
        f"{label}: device and host residuals disagree",
    )


def _polish_and_certify(torch, st, cuda_kernels, label, model, film_data, circulating, kwargs):
    """``solve_many(final_refine=2)`` on ``model``: the report's residual
    after the polish must be at most POLISHED_RESIDUAL_MAX; the delivered
    float64 streams are certified again, and so are those of the same
    sweep delivered in float32.  Returns the float64 result."""
    from superscreen_tpu_torch import certify

    _reset_launches(cuda_kernels)
    polished, polished_s = _sweep(torch, st, model=model, final_refine=2, **kwargs)
    launches = dict(cuda_kernels.LAUNCHES)
    report = polished.final_refine_report
    print(f"{label} solve_many(final_refine=2): {polished_s:.4f} s, launches {launches}, {report}")
    _require(all(a.dtype == np.float64 for a in polished.streams.values()), "polished dtype")
    _require(
        all(a.dtype == np.float64 for d in (polished.current_densities, polished.self_fields)
            for a in d.values()),
        "polished outputs dtype",
    )
    _require(
        0 < report["residual_rel_max_after"] <= POLISHED_RESIDUAL_MAX,
        f"{label}: polished residual {report['residual_rel_max_after']:.3e}",
    )
    again = certify.certify_sweep(
        *_certify_inputs(model, polished, film_data, circulating), refine_steps=0, n_sample_rows=64
    )
    cast, _ = _sweep(
        torch, st, model=model, final_refine=2, result_dtype="float32", **kwargs
    )
    _require(all(a.dtype == np.float32 for a in cast.streams.values()), "cast dtype")
    cast_again = certify.certify_sweep(
        *_certify_inputs(model, cast, film_data, circulating), refine_steps=0, n_sample_rows=0
    )
    print(
        f"{label} delivered streams certified again: float64 {again['residual_rel_max']:.3e} "
        f"(limit {RECERTIFIED_RESIDUAL_MAX:.0e}; the fields come back through the result's "
        f"float32 field units), cast to float32 {cast_again['residual_rel_max']:.3e} "
        f"(the JAX package's polished figure on its own device and mesh: "
        f"{JAX_POLISHED_RESIDUAL:.2e})"
    )
    _require(again["residual_rel_max"] <= RECERTIFIED_RESIDUAL_MAX, f"{label}: re-certified")
    return polished


def phase_certify(torch, st, cuda_kernels, model, large):
    """Phase 10 on phase 4's model and phase 7's sweep; returns the launch
    counts of one certification."""
    import logging

    from superscreen_tpu_torch import certify

    fields = [st.sources.ConstantField(v) for v in SWEEP_FIELDS]
    B = len(fields)
    kwargs = dict(applied_fields=fields, iterations=ITERATIONS)
    n_films = len(model.device.films)
    result, _ = _sweep(torch, st, model=model, **kwargs)
    inputs = _certify_inputs(model, result)
    certify.certify_sweep(*inputs)  # warm
    _reset_launches(cuda_kernels)
    report, certify_s = _wall(torch, lambda: certify.certify_sweep(*inputs))
    launches = dict(cuda_kernels.LAUNCHES)
    print(f"phase10 certify_sweep (B={B}): {certify_s:.3f} s, launches {launches}")
    _print_certificate("phase10", report)
    _require(set(report["films_certified"]) == set(model.device.films), "films certified")
    _require(0 < report["residual_rel_max"] <= RESIDUAL_MAX, "certified residual")
    # One residual of the delivered streams and one per refinement step.
    _require(launches["residual_f64"] == 4 * n_films, launches)

    polished = _polish_and_certify(
        torch, st, cuda_kernels, "phase10", model, None, None, kwargs
    )
    # The polish alone, on the same inputs, and the sweep with and without
    # it in turns.
    def polish():
        streams, _ = certify.refine_sweep_f64(*inputs, steps=2, result_dtype="float64")
        return certify.sweep_outputs_from_streams(model.film_data, streams)

    polish()
    _, polish_s = _wall(torch, polish)
    times = {0: [], 2: []}
    for steps in (0, 2, 2, 0):
        times[steps].append(_sweep(torch, st, model=model, final_refine=steps, **kwargs)[1])
    print(
        f"phase10 the polish alone (2 steps, then J and the self-fields in float64): "
        f"{polish_s:.4f} s; warm sweep without it {min(times[0]):.4f} s, with it "
        f"{min(times[2]):.4f} s"
    )
    _profile(
        torch, lambda: _sweep(torch, st, model=model, final_refine=2, **kwargs)[1],
        "phase10 profile of the warm polished sweep",
    )

    # check_inversion holds every entry of the residual to numpy.allclose's
    # 1e-5 of the right-hand side, as the JAX package's check does.  The
    # float64 solve of the sound model must pass it; a float32 solve of
    # 16,768 unknowns (residual norm ~1e-5) is reported, not required to.
    def checked_solve(**options):
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logger = logging.getLogger("solve")
        logger.addHandler(handler)
        try:
            solutions, seconds = _wall(
                torch,
                lambda: st.solve(
                    model=model, applied_field=st.sources.ConstantField(1.0),
                    iterations=ITERATIONS, check_inversion=True, torch_device=CARD, **options,
                ),
            )
        finally:
            logger.removeHandler(handler)
        _require(len(solutions) == ITERATIONS + 1, "check_inversion solutions")
        warned = [r.getMessage() for r in records if "Unable to solve" in r.getMessage()]
        return warned, seconds

    # high_precision: float32 factors + float64 systems and refinement,
    # against a direct float64 factorization of the same stack ("inv"),
    # both on the card.
    def hp_solve():
        return st.solve(
            model=model, applied_field=st.sources.ConstantField(1.0), iterations=ITERATIONS,
            high_precision=True, torch_device=CARD,
        )

    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(cuda_kernels)
    hp, hp_cold_s = _wall(torch, hp_solve)
    hp_launches = dict(cuda_kernels.LAUNCHES)
    hp_peak = torch.cuda.max_memory_allocated() / 1e9
    assembly = {n: round(v.stats["assembly_s"], 3) for n, v in model.hp_model.hp_systems.items()}
    hp_warm_s = min(_wall(torch, hp_solve)[1] for _ in range(2))
    print(
        f"phase10 solve(high_precision=True, iterations={ITERATIONS}): cold {hp_cold_s:.3f} s "
        f"(float64 assembly per film {assembly}), warm {hp_warm_s:.4f} s, launches of the cold "
        f"solve {hp_launches}; peak_memory_GB={hp_peak:.3f} with {resident:.3f} resident before "
        f"(the float32 model: A and its factors)"
    )
    _require(all(fs.stream.dtype == np.float64 for fs in hp[-1].film_solutions.values()), "hp dtype")
    _profile(torch, lambda: _wall(torch, hp_solve)[1], "phase10 profile of the warm high-precision solve")
    _time_float64_kernels(torch, model)
    warned, checked_s = checked_solve(high_precision=True)
    print(
        f"phase10 solve(high_precision=True, check_inversion=True): {checked_s:.4f} s, "
        f"{len(warned)} warnings (limit 0)"
    )
    _require(not warned, f"check_inversion warned on the sound model: {warned[:1]}")
    warned, checked_s = checked_solve()
    print(
        f"phase10 solve(check_inversion=True) in float32: {checked_s:.4f} s, {len(warned)} "
        f"warnings of {len(model.device.films) * (ITERATIONS + 1)} film solves; first: {warned[:1]}"
    )
    model.hp_model = None
    torch.cuda.empty_cache()
    dev64 = large.copy()
    dev64.solve_dtype = "float64"
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    model64, factor64_s = _wall(
        torch,
        lambda: st.factorize_model(
            device=dev64, current_units="uA", circulating_currents={"hole0": "1 mA"},
            torch_device=CARD,
        ),
    )
    f64, f64_cold_s = _solve(torch, st, model64)
    f64_peak = torch.cuda.max_memory_allocated() / 1e9
    f64_warm_s = min(_solve(torch, st, model64)[1] for _ in range(2))
    print(
        f"phase10 direct float64 factorization ('inv') of the same stack: factorize {factor64_s:.3f} s, solve cold "
        f"{f64_cold_s:.4f} s, warm {f64_warm_s:.4f} s; peak_memory_GB={f64_peak:.3f} with "
        f"{resident:.3f} resident before"
    )
    err_hp = _stream_error(hp, f64)

    def polished_error(swept):
        return max(
            float(np.abs(swept.streams[name][B - 1] - fs.stream).max() / np.abs(fs.stream).max())
            for name, fs in f64[-1].film_solutions.items()
        )

    # The polish solves the final round's float32 systems exactly.  Their
    # right-hand sides carry the field of the other films from the inner
    # rounds, so both the default sweep and the one with refined inner
    # rounds are compared; what remains is the float32 assembly.
    err_default = polished_error(polished)
    with _environ(SUPERSCREEN_TPU_INNER_REFINE="2"):
        refined, _ = _sweep(torch, st, model=model, final_refine=2, **kwargs)
    err_polished = polished_error(refined)
    print(
        f"phase10 high_precision streams against the float64 model's: {err_hp:.3e} (limit "
        f"{HP_STREAM_REL_MAX:.0e}); the polished float32-system streams (point {B - 1}) against "
        f"them: {err_polished:.3e} with SUPERSCREEN_TPU_INNER_REFINE=2 (limit "
        f"{POLISHED_STREAM_REL_MAX:.0e}: the polish solves the float32-assembled systems "
        f"exactly), "
        f"{err_default:.3e} with the inner rounds unrefined (the default)"
    )
    _require(err_hp <= HP_STREAM_REL_MAX, f"high_precision stream error {err_hp:.3e}")
    _require(err_polished <= POLISHED_STREAM_REL_MAX, f"polished stream error {err_polished:.3e}")
    return launches


def _time_float64_kernels(torch, model):
    """q_apply and biot_savart_batch in float64 at the shapes of the
    high-precision solve: the self-field (all sites of a film, one column
    per round) and one coupling pass (film 0 on film 1, B = 1)."""
    from superscreen_tpu_torch.ops import cuda_kernels

    data = list(model.hp_model.film_data.values())
    a, b = data[0], data[1]
    rng = np.random.default_rng(11)
    k = ITERATIONS + 1
    V = torch.as_tensor(rng.standard_normal((a.n, k)), device=CARD)
    ms = _timed(torch, lambda: cuda_kernels.q_apply(a.sites, a.sites, V), 5)
    bound = _bound("q_apply", torch.float64, a.n, a.n, k)
    print(f"phase10 q_apply float64 m=n={a.n} k={k} (self-field): kernel_ms={ms:.4f} {_bound_text(bound, ms)}")
    J = torch.as_tensor(rng.standard_normal((1, a.n, 2)), device=CARD)
    dz2 = (b.z0 - a.z0) ** 2
    ms = _timed(torch, lambda: cuda_kernels.biot_savart_batch(a.sites, a.weights, J, b.sites, dz2), 5)
    bound = _bound("biot_savart_batch", torch.float64, b.n, a.n, 1)
    print(
        f"phase10 biot_savart_batch float64 n1={a.n} n2={b.n} B=1 (coupling pass): "
        f"kernel_ms={ms:.4f} {_bound_text(bound, ms)}"
    )


def _certify_transport(torch, st, cuda_kernels, device, vortex_model, sweep_kwargs):
    """Phase 10 on phase 8's transport stack: certify_sweep and the polish
    for the terminal film (dense, with per-point transport offsets) on a
    model without vortices, and the vortex model's strip noted as
    skipped."""
    from superscreen_tpu_torch import certify, sweep as sweep_module

    B = len(sweep_kwargs["applied_fields"])
    kwargs = {k: v for k, v in sweep_kwargs.items() if k != "vortex_nPhi0"}
    model = st.factorize_model(device=device, current_units="uA", torch_device=CARD)
    result, _ = _sweep(torch, st, model=model, **kwargs)
    film_data, _ = sweep_module._apply_terminal_sweeps(
        model, model.film_data, kwargs["terminal_currents"], B, "uA"
    )
    _require(film_data["strip"].g_offset.shape == (B, film_data["strip"].n), "swept offsets")
    circulating = kwargs["circulating_currents"]
    report = certify.certify_sweep(*_certify_inputs(model, result, film_data, circulating))
    _print_certificate("phase10 transport stack without vortices", report)
    _require(set(report["films_certified"]) == {"strip", "ring"}, "transport films certified")
    _require(0 < report["residual_rel_max"] <= RESIDUAL_MAX, "transport certified residual")
    _polish_and_certify(
        torch, st, cuda_kernels, "phase10 transport stack", model, film_data, circulating, kwargs
    )
    del model, film_data
    torch.cuda.empty_cache()
    # With vortices in the strip: skipped with a note, the ring certified.
    swept, _ = _sweep(torch, st, model=vortex_model, **sweep_kwargs)
    film_data, _ = sweep_module._apply_vortex_amplitudes(
        vortex_model, vortex_model.film_data, sweep_kwargs["vortex_nPhi0"], B
    )
    film_data, _ = sweep_module._apply_terminal_sweeps(
        vortex_model, film_data, sweep_kwargs["terminal_currents"], B, "uA"
    )
    report = certify.certify_sweep(
        *_certify_inputs(vortex_model, swept, film_data, circulating), n_sample_rows=64
    )
    _print_certificate("phase10 transport stack with vortices", report)
    _require("strip" in report.get("films_skipped", {}), "vortex film not skipped")
    _require(report["films_certified"] == ["ring"], "ring not certified")


def phase_huber(torch, st, cuda_kernels):
    """Phase 11: the Huber susceptometer's pickup-loop / field-coil mutual
    inductance, meshed by this package at the layout's published edge
    length, in float32, polished, at high precision and on a float64 copy;
    then the closed layout through mutual_inductance_matrix."""
    from superscreen_tpu_torch.squids import mutuals

    def pH_and_phi0(value):
        q = value * st.ureg("pH")
        return f"{value:.6f} pH ({q.to('Phi_0 / A').magnitude:.4f} Phi_0/A)"

    for with_terminals in (True, False):
        kind = "terminal" if with_terminals else "closed"
        t0 = time.perf_counter()
        device = mutuals.SQUID_LAYOUTS["huber"](with_terminals=with_terminals)
        device.make_mesh(max_edge_length=mutuals.MAX_EDGE_LENGTHS["huber"], smooth=100)
        sizes = {name: len(mesh.sites) for name, mesh in device.meshes.items()}
        print(
            f"phase11 huber ({kind}) meshed at max_edge_length="
            f"{mutuals.MAX_EDGE_LENGTHS['huber']}, smooth=100: {sizes}, "
            f"{time.perf_counter() - t0:.3f} s"
        )
        dev64 = device.copy()
        dev64.solve_dtype = "float64"
        runs = [
            ("float32", device, {}),
            ("float32 + final_refine=2", device, dict(final_refine=2)),
            ("high_precision", device, dict(high_precision=True)),
            ("float64", dev64, {}),
        ]
        values = {}
        for label, dev, options in runs:
            if not with_terminals and "final_refine" in options:
                continue  # the closed layout's matrix has no polished route
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(cuda_kernels)
            value, seconds = _wall(
                torch,
                lambda: mutuals.pickup_loop_mutual(
                    dev, iterations=ITERATIONS, units="pH", torch_device=CARD, **options
                ),
            )
            values[label] = float(value.magnitude)
            print(
                f"phase11 huber ({kind}) pickup_loop_mutual {label}: {pH_and_phi0(values[label])}, "
                f"{seconds:.3f} s (factorization included), launches {dict(cuda_kernels.LAUNCHES)}, "
                f"peak_memory_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}"
            )
        exact = values["float64"]
        errs = {label: abs(v - exact) / abs(exact) for label, v in values.items()}
        print(
            f"phase11 huber ({kind}) against the card's float64: "
            + ", ".join(f"{label} {err:.3e}" for label, err in errs.items() if label != "float64")
            + f" (limits: float32 {MUTUAL_F32_TOL:.0e}, high_precision {HP_MUTUAL_TOL:.0e})"
        )
        _require(np.isfinite(exact) and exact > 0, "huber mutual")
        _require(errs["float32"] <= MUTUAL_F32_TOL, f"huber float32 {errs['float32']:.3e}")
        _require(errs["high_precision"] <= HP_MUTUAL_TOL, f"huber hp {errs['high_precision']:.3e}")
        if with_terminals:
            off = abs(exact - JAX_HUBER_MUTUAL_PH) / JAX_HUBER_MUTUAL_PH
            print(
                f"phase11 huber (terminal) beside the JAX package's {JAX_HUBER_MUTUAL_PH} pH "
                f"({JAX_MUTUAL_REL_ERR:.2e} off its float64, on its own mesh): {off:.3e} apart "
                f"(limit {JAX_HUBER_TOL:.0e}: two meshers' triangles)"
            )
            _require(off <= JAX_HUBER_TOL, f"huber against the JAX package {off:.3e}")


def _round_data(torch, model_data=None, device=None, grids=None):
    """Per-film stand-ins of ``FilmSweepData`` with what one coupling round
    reads (sites, weights, height, FFT grid), from a model's film data or
    from a bare meshed ``device``."""
    from types import SimpleNamespace

    if model_data is not None:
        return {
            name: SimpleNamespace(sites=d.sites, weights=d.weights, z0=d.z0, fft_grid=grids[name])
            for name, d in model_data.items()
        }
    out = {}
    for name, mesh in device.meshes.items():
        out[name] = SimpleNamespace(
            sites=torch.as_tensor(mesh.sites, dtype=torch.float32, device=CARD),
            weights=torch.as_tensor(mesh.vertex_areas, dtype=torch.float32, device=CARD),
            z0=float(device.layers[device.films[name].layer].z0),
            fft_grid=grids[name],
        )
    return out


def _time_rounds(torch, cuda_kernels, data, streams, Js, label, profile=False):
    """One exact and one FFT coupling round timed by CUDA events (in
    turns), with their launch counts; with ``profile`` also ITERATIONS
    rounds of each under torch.profiler.  Returns the two times in ms,
    and with ``profile`` the device ms of one FFT round ("fft_device")."""
    from superscreen_tpu_torch.sweep import _coupling_round

    films = list(data)
    Hz = {name: torch.zeros_like(streams[name]) for name in films}

    def run(coupling):
        return _coupling_round(data, films, streams, Js, Hz, coupling)

    counts = {}
    for coupling in ("exact", "fft"):
        _reset_launches(cuda_kernels)
        run(coupling)
        counts[coupling] = dict(cuda_kernels.LAUNCHES)
    _require(counts["fft"]["biot_savart_batch"] == 0, counts)
    _require(counts["exact"]["biot_savart_batch"] == len(films) * (len(films) - 1), counts)
    times = {"exact": [], "fft": []}
    for coupling in ("exact", "fft", "fft", "exact"):
        times[coupling].append(_timed(torch, lambda: run(coupling), 5))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    print(
        f"{label}: one coupling round exact {ms['exact']:.3f} ms "
        f"{[round(t, 3) for t in times['exact']]} (biot_savart_batch launches "
        f"{counts['exact']['biot_savart_batch']}), FFT {ms['fft']:.3f} ms "
        f"{[round(t, 3) for t in times['fft']]} (cuFFT, gathers, transfer; "
        f"{ms['exact'] / ms['fft']:.2f}x)"
    )
    if profile:
        for coupling in ("fft", "exact"):
            def rounds(coupling=coupling):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ITERATIONS):
                    run(coupling)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            device_ms = _profile(
                torch, rounds, f"{label} profile of {ITERATIONS} {coupling} rounds"
            )
            if coupling == "fft":
                ms["fft_device"] = device_ms / ITERATIONS
    return ms


def phase_fft(torch, st, cuda_kernels, model, exact):
    """Phase 12: the FFT inter-film coupling.  (a) Phase 4's model (27k
    stack, low-memory LU, float32): solve_many(coupling="fft") with phase
    7's fields and ITERATIONS rounds against phase 7's exact sweep, then
    solve(coupling="fft") at B = 1; (b) pairs of disks of bench.py's
    payoff shape at SITES_PAIRS sites per film and the Huber
    susceptometer: one exact round against one FFT round each; (c) the
    cost-model constants of coupling="auto" fitted on (a) and (b), and
    each decision beside the measured faster mode.  Returns the launch
    counts of the FFT sweep and the cells where the package's decision
    loses by more than AUTO_TIE."""
    from superscreen_tpu_torch import sweep
    from superscreen_tpu_torch.ops import fft_coupling

    device = model.device
    films = list(device.films)
    fields = [st.sources.ConstantField(v) for v in SWEEP_FIELDS]
    B = len(fields)
    kwargs = dict(model=model, applied_fields=fields, iterations=ITERATIONS, coupling="fft")
    model.fft_grids = None
    grids, build_s = _wall(
        torch, lambda: fft_coupling.build_film_grid_data(device, model.torch_device)
    )
    model.fft_grids = grids
    G = grids[films[0]].kmag.shape[0]
    sizes = [len(device.meshes[name].sites) for name in films]
    print(
        f"phase12 27k stack: G={G} (predicted {sweep._predict_fft_grid(device)}), grid build "
        f"(cold, host) {build_s:.3f} s, sites {sizes}"
    )
    _reset_launches(cuda_kernels)
    result, cold_s = _sweep(torch, st, **kwargs)
    launches = dict(cuda_kernels.LAUNCHES)
    print(f"phase12 launches of one FFT sweep (B={B}, iterations={ITERATIONS}): {launches}")
    _require(launches["biot_savart_batch"] == 0 and launches["biot_savart_pair"] == 0, launches)
    _require(launches["q_apply"] == len(films), launches)
    _require(launches["residual_f64"] == 3 * len(films), launches)
    for arrays in (result.streams, result.current_densities, result.other_fields):
        _require(all(np.all(np.isfinite(a)) for a in arrays.values()), "non-finite FFT sweep")
    _check_sweep_residuals(torch, model, result, "phase12 FFT sweep")
    # Against max|g| of each film over the sweep (the bar), and per point.
    err = max(
        float(np.abs(result.streams[name] - g).max() / np.abs(g).max())
        for name, g in exact.streams.items()
    )
    per_point = _sweep_stream_error(result, exact)
    print(
        f"phase12 FFT sweep against phase 7's exact sweep: max stream difference {err:.3e} of "
        f"each film's max|g| (limit {FFT_STREAM_REL_MAX:.0e}, the JAX package's test bar); "
        f"{per_point:.3e} of the point's own max|g| at the worst point"
    )
    _require(err <= FFT_STREAM_REL_MAX, f"FFT against exact {err:.3e}")
    times = {"fft": [], "exact": []}
    for coupling in ("fft", "exact", "exact", "fft"):
        times[coupling].append(_sweep(torch, st, **{**kwargs, "coupling": coupling})[1])
    print(
        f"phase12 solve_many wall: FFT cold_s={cold_s:.4f} (grids cached), warm "
        f"{np.mean(times['fft']):.4f} s {[round(t, 4) for t in times['fft']]}; exact warm "
        f"{np.mean(times['exact']):.4f} s {[round(t, 4) for t in times['exact']]} in turns"
    )
    solutions, solve_s = _wall(
        torch,
        lambda: st.solve(model=model, applied_field=fields[-1], iterations=ITERATIONS,
                         coupling="fft", torch_device=CARD),
    )
    _check_residuals(torch, model, solutions[-1], "phase12 FFT solve()")
    err_solve = max(
        float(np.abs(result.streams[name][B - 1] - fs.stream).max() / np.abs(fs.stream).max())
        for name, fs in solutions[-1].film_solutions.items()
    )
    print(
        f"phase12 FFT solve() at B=1: {solve_s:.4f} s; FFT sweep point {B - 1} against it "
        f"{err_solve:.3e} (limit {STREAM_REL_MAX:.0e})"
    )
    _require(err_solve <= STREAM_REL_MAX, f"FFT sweep against FFT solve() {err_solve:.3e}")
    # The coupling alone, on the sweep's final streams and currents.
    dev = dict(device=CARD)
    streams = {n: torch.as_tensor(result.streams[n], **dev) for n in films}
    Js = {n: torch.as_tensor(result.current_densities[n], **dev) for n in films}
    stack = _time_rounds(
        torch, cuda_kernels, _round_data(torch, model.film_data, grids=grids), streams, Js,
        f"phase12 27k stack, B={B}", profile=True,
    )
    del streams, Js
    wrong = _fit_auto(torch, st, cuda_kernels, ("27k stack", sizes, G, stack, True))
    decision = sweep._resolve_auto_coupling(model, films, ITERATIONS)
    print(f"phase12 the package's auto decision on the 27k stack: {decision}")
    return launches, wrong


def _fit_auto(torch, st, cuda_kernels, stack_cell):
    """Phase 12 (b) and (c): one exact and one FFT round on each layout,
    the cost model fitted on them and ``stack_cell`` (label, sizes, G,
    measured ms, distinct heights), and each decision of coupling="auto"
    beside the measured faster mode.  Returns the cells where the
    package's decision loses by more than AUTO_TIE."""
    from superscreen_tpu_torch import sweep
    from superscreen_tpu_torch.ops import fft_coupling
    from superscreen_tpu_torch.squids import mutuals

    dev = dict(device=CARD)
    # (b) Pairs of disks of the payoff pair's shape at three sizes, and the
    # Huber susceptometer's four films, on seeded streams and currents.
    cells = [stack_cell]
    rng = np.random.default_rng(7)
    layouts = [(f"pair of {n} sites", lambda n=n: _payoff_pair(st, n)) for n in SITES_PAIRS]
    layouts.append(("huber", lambda: _huber_layout(mutuals)))
    for label, make in layouts:
        layout, mesh_s = _wall(torch, make)
        layout_grids, layout_build_s = _wall(
            torch, lambda: fft_coupling.build_film_grid_data(layout, CARD)
        )
        layout_sizes = [len(m.sites) for m in layout.meshes.values()]
        layout_G = next(iter(layout_grids.values())).kmag.shape[0]
        print(
            f"phase12 {label}: sites {layout_sizes}, meshed in {mesh_s:.3f} s, G={layout_G} "
            f"(predicted {sweep._predict_fft_grid(layout)}), grid build {layout_build_s:.3f} s"
        )
        _require(sweep._predict_fft_grid(layout) == layout_G, f"{label}: predicted grid")
        streams = {
            n: torch.as_tensor(rng.standard_normal((PAYOFF_B, k)), dtype=torch.float32, **dev)
            for n, k in zip(layout.meshes, layout_sizes)
        }
        Js = {
            n: torch.as_tensor(rng.standard_normal((PAYOFF_B, k, 2)), dtype=torch.float32, **dev)
            for n, k in zip(layout.meshes, layout_sizes)
        }
        ms = _time_rounds(
            torch, cuda_kernels, _round_data(torch, device=layout, grids=layout_grids), streams,
            Js, f"phase12 {label}, B={PAYOFF_B}",
        )
        z0s = [layout.layers[film.layer].z0 for film in layout.films.values()]
        cells.append((label, layout_sizes, layout_G, ms, len(set(z0s)) == len(z0s)))
        del layout, layout_grids, streams, Js
    # (c) The cost model: exact ms = A * (site pairs) + E * (ordered film
    # pairs), fitted on all cells; FFT ms = n_films * max(F, C * G^2 log2 G):
    # F, the launch floor per film, fitted on all cells, C from the device
    # time of the stack's FFT rounds (the first cell, profiled).
    exact_fit = _fit_nonnegative(
        [[sum(n) ** 2 - sum(k * k for k in n), len(n) * (len(n) - 1)] for _, n, *_ in cells],
        [ms["exact"] for _, _, _, ms, _ in cells],
    )
    per_film = np.array([len(n) / ms["fft"] for _, n, _, ms, _ in cells])
    floor = float(per_film.sum() / (per_film @ per_film))  # relative least squares
    _, n0, g0, ms0, _ = cells[0]
    device_coef = ms0["fft_device"] / (len(n0) * g0 * g0 * np.log2(g0))
    fit = (*exact_fit, floor, device_coef)
    package = (
        sweep._EXACT_MS_PER_PAIR_SITE2, sweep._EXACT_MS_PER_FILM_PAIR, sweep._FFT_MS_PER_FILM,
        sweep._FFT_DEVICE_MS_PER_GRID_UNIT,
    )
    names = ("_EXACT_MS_PER_PAIR_SITE2", "_EXACT_MS_PER_FILM_PAIR", "_FFT_MS_PER_FILM",
             "_FFT_DEVICE_MS_PER_GRID_UNIT")
    print(
        f"phase12 fitted cost model on {len(cells)} cells (B={PAYOFF_B}): "
        + " ".join(f"{k}={v:.4g}" for k, v in zip(names, fit))
        + " (in the package: " + ", ".join(f"{v:.4g}" for v in package) + ")"
    )
    # Each decision beside the measured faster mode.  The package's must
    # agree wherever one mode is more than AUTO_TIE faster.  (Films that
    # share a height are exact whatever the cost: the FFT transfer needs
    # dz > 0.  Their rounds are timed for the fit only.)
    wrong = []
    for label, n, g, ms, distinct in cells:
        measured = "fft" if ms["fft"] < ms["exact"] else "exact"
        for model_name, predict in (
            ("this run's fit", lambda n, g: _port_cost_ms(fit, n, g)),
            ("the package's constants", sweep._coupling_round_ms),
            ("the JAX package's TPU v5e constants", lambda n, g: _jax_cost_ms(n, g)),
        ):
            pred = predict(n, g)
            choice = "fft" if pred["fft"] < pred["exact"] else "exact"
            print(
                f"phase12 auto decision, {label}, {model_name}: exact {pred['exact']:.3f} ms "
                f"(measured {ms['exact']:.3f}), fft {pred['fft']:.3f} ms (measured "
                f"{ms['fft']:.3f}) -> {choice}; measured faster: {measured}"
            )
        if not distinct:
            print(f"phase12 auto decision, {label}: exact (films share a height)")
            continue
        choice = sweep._coupling_round_ms(n, g)
        choice = "fft" if choice["fft"] < choice["exact"] else "exact"
        ratio = max(ms["exact"], ms["fft"]) / min(ms["exact"], ms["fft"])
        if choice != measured and ratio > AUTO_TIE:
            wrong.append((label, choice, measured, round(ratio, 3)))
    # Where auto switches for two disks of the pairs' shape, the grid
    # interpolated in sqrt(sites) between the measured pairs.
    pair_n = [float(np.mean(n)) for label, n, *_ in cells if label.startswith("pair")]
    pair_G = [g for label, _, g, *_ in cells if label.startswith("pair")]
    for model_name, predict in (
        ("this run's fit", lambda n, g: _port_cost_ms(fit, n, g)),
        ("the package's constants", sweep._coupling_round_ms),
    ):
        def picks_fft(n):
            g = fft_coupling.friendly_grid_size(
                int(np.interp(np.sqrt(n), np.sqrt(pair_n), pair_G))
            )
            pred = predict([n, n], g)
            return pred["fft"] < pred["exact"]

        first = next((n for n in range(1000, 200001, 500) if picks_fft(n)), None)
        print(f"phase12 two disks of the pairs' shape: {model_name} pick fft from {first} "
              f"sites per film")
    print(f"phase12 package decisions against the measured faster mode (ties within "
          f"{AUTO_TIE}x excepted): {'all agree' if not wrong else wrong}")
    return wrong


def _payoff_pair(st, sites):
    """Two disks of bench.py's fft_coupling_payoff shape (radii 7.5 and 6.0,
    heights 0 and 1) meshed to about ``sites`` sites each."""
    layers = [st.Layer("layer0", Lambda=1.0, z0=0), st.Layer("layer1", Lambda=0.5, z0=1)]
    films = [
        st.Polygon("f0", layer="layer0", points=st.geometry.circle(7.5, points=120)),
        st.Polygon("f1", layer="layer1", points=st.geometry.circle(6.0, points=110)),
    ]
    pair = st.Device("fftpair", layers=layers, films=films)
    pair.make_mesh(min_points=sites)
    return pair


def _huber_layout(mutuals):
    """The Huber susceptometer with terminals at its published edge length
    (phase 11's mesh)."""
    device = mutuals.SQUID_LAYOUTS["huber"](with_terminals=True)
    device.make_mesh(max_edge_length=mutuals.MAX_EDGE_LENGTHS["huber"], smooth=100)
    return device


def _fit_nonnegative(rows, y):
    """Non-negative least squares of ``rows @ c = y`` in relative terms
    (each row divided by its ``y``), for two columns: both, or the one
    column alone that fits the better."""
    M = np.asarray(rows, dtype=float) / np.asarray(y, dtype=float)[:, None]
    ones = np.ones(len(y))
    coef = np.linalg.lstsq(M, ones, rcond=None)[0]
    if np.all(coef >= 0):
        return tuple(float(c) for c in coef)
    singles = [float(M[:, j] @ ones / (M[:, j] @ M[:, j])) for j in (0, 1)]
    errs = [np.abs(M[:, j] * c - 1).max() for j, c in enumerate(singles)]
    j = int(np.argmin(errs))
    return (singles[0], 0.0) if j == 0 else (0.0, singles[1])


def _port_cost_ms(consts, sizes, G):
    """The port's per-round cost model (sweep._coupling_round_ms) with the
    constants ``(A, E, F, C)``."""
    n = len(sizes)
    return {
        "exact": consts[0] * (sum(sizes) ** 2 - sum(k * k for k in sizes)) + consts[1] * n * (n - 1),
        "fft": n * max(consts[2], consts[3] * G * G * np.log2(G)),
    }


def _jax_cost_ms(sizes, G):
    """The JAX package's per-round cost model with its TPU constants."""
    exact, grid, site = JAX_COST_MODEL
    return {
        "exact": exact * (sum(sizes) ** 2 - sum(k * k for k in sizes)),
        "fft": grid * len(sizes) * G * G * np.log2(G) + site * sum(sizes),
    }


def _scanning_devices(st, dtype="float32"):
    """BASELINE config 5 (bench.py _scanning_config), meshed by this
    package: the mini SQUID and the 6 um disk sample."""
    squid = st.Device(
        "mini_squid",
        layers=[st.Layer("sq", Lambda=0.3, z0=0)],
        films=[st.Polygon("fc_ring", layer="sq", points=st.geometry.circle(1.5, points=80))],
        holes=[st.Polygon("fc_hole", layer="sq", points=st.geometry.circle(0.9, points=50))],
        abstract_regions=[st.Polygon("pl", layer="sq", points=st.geometry.circle(0.4, points=48))],
        length_units="um",
        solve_dtype=dtype,
    )
    squid.make_mesh(min_points=SCAN_SQUID_POINTS, smooth=5)
    sample = st.Device(
        "sample",
        layers=[st.Layer("s", Lambda=0.1, z0=0)],
        films=[st.Polygon("disk", layer="s", points=st.geometry.circle(6.0, points=160))],
        length_units="um",
        solve_dtype=dtype,
    )
    sample.make_mesh(min_points=SCAN_SAMPLE_POINTS)
    return squid, sample


def _scan_kernel_row(torch, kernels, cuda_kernels, label, src_sites, areas, J, dst, dz2, launches):
    """biot_savart_batch at a scanning shape against its plain version,
    timed beside its bound (B = 1)."""
    out = kernels.biot_savart_film_to_film_dz2(src_sites, areas, J, dst, dz2)
    abs_err, rel = _check_against_plain(
        torch, label, torch.float32, out, kernels.biot_savart_plain(src_sites, areas, J[None], dst, dz2)[0]
    )
    ms = _timed(torch, lambda: kernels.biot_savart_film_to_film_dz2(src_sites, areas, J, dst, dz2), 10)
    plain_ms = _timed(torch, lambda: kernels.biot_savart_plain(src_sites, areas, J[None], dst, dz2), 3)
    bound = _bound("biot_savart_batch", torch.float32, dst.shape[0], src_sites.shape[0], 1)
    print(
        f"phase13 {label} (biot_savart_batch, {src_sites.shape[0]} sites -> {dst.shape[0]} points, "
        f"B=1): max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL['float32']:.0e}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {_bound_text(bound, ms)}; launches per scan "
        f"{launches}"
    )


def phase_scanning(torch, st, kernels, cuda_kernels):
    """Phase 13: BASELINE config 5 (susceptibility scan at 64 positions,
    float32, against the port's own float64 run; back action; magnetometry
    with screening over a Pearl vortex), the current imaging of a solved
    ring, and a vortex energy landscape.  Returns the launch counts of the
    scan, and the config-5 sample, positions and SQUID solutions (float32
    and float64) for phase 14."""
    from superscreen_tpu_torch.ops import interp
    from superscreen_tpu_torch.squids import scanning

    squid, sample = _scanning_devices(st)
    sq_n, s_n = len(squid.meshes["fc_ring"].sites), len(sample.meshes["disk"].sites)
    print(f"phase13 config 5: SQUID {sq_n} sites, sample {s_n} sites, B={SCAN_B}")
    positions = np.column_stack([np.linspace(-8.0, 8.0, SCAN_B), np.zeros(SCAN_B)])
    drive = dict(applied_field=st.sources.ConstantField(0), circulating_currents={"fc_hole": "1 mA"},
                 field_units="mT", current_units="mA", torch_device=CARD)
    squid_solution = st.solve(squid, **drive)[-1]
    model = st.factorize_model(device=sample, current_units="uA", torch_device=CARD)
    scan = dict(squid_solution=squid_solution, positions=positions, squid_height=1.0,
                pickup_loop="pl", I_fc="1 mA", torch_device=CARD)
    _reset_launches(cuda_kernels)
    M, cold_s = _wall(torch, lambda: scanning.susceptibility_scan(sample_model=model, **scan))
    launches = dict(cuda_kernels.LAUNCHES)
    _require(launches["biot_savart_batch"] == 1, launches)
    _require(M.shape == (SCAN_B,) and bool(np.all(np.isfinite(M))), "scan output")
    warm = [_wall(torch, lambda: scanning.susceptibility_scan(sample_model=model, **scan))[1]
            for _ in range(3)]
    mirror = float(np.abs(M - M[::-1]).max() / np.abs(M).max())
    print(
        f"phase13 susceptibility scan: launches {launches}; cold {cold_s:.4f} s, warm "
        f"{[round(t, 4) for t in warm]} s = {min(warm) / SCAN_B * 1e3:.3f} ms per position; "
        f"M range [{M.min():.4f}, {M.max():.4f}] Phi_0/A; mirror symmetry {mirror:.3e} "
        f"(limit {MIRROR_MAX:.0e}; the JAX package's {JAX_MIRROR:.3e}, its own mesher)"
    )
    _require(mirror <= MIRROR_MAX, f"mirror symmetry {mirror:.3e}")
    _profile(torch, lambda: _wall(torch, lambda: scanning.susceptibility_scan(
        sample_model=model, **scan))[1], "phase13 profile of the warm scan")
    # The float64 run on the card of the same meshes, at three positions.
    squid64, sample64 = squid.copy(), sample.copy()
    squid64.solve_dtype = sample64.solve_dtype = "float64"
    squid64_solution = st.solve(squid64, **drive)[-1]
    idx = list(SCAN_CHECK)
    M64 = scanning.susceptibility_scan(
        sample64, **{**scan, "squid_solution": squid64_solution, "positions": positions[idx]}
    )
    f64_err = float(np.abs(M[idx] - M64).max() / np.abs(M64).max())
    print(
        f"phase13 float32 against the card's float64 at positions {idx}: {f64_err:.3e} "
        f"(limit {SCAN_F64_MAX:.0e}; the JAX package's {JAX_SCAN_F64:.3e})"
    )
    _require(f64_err <= SCAN_F64_MAX, f"scan f32 against f64 {f64_err:.3e}")
    # The kernel at the scan's shapes.
    dev = dict(dtype=torch.float32, device=CARD)
    sq_mesh, s_mesh = squid.meshes["fc_ring"], sample.meshes["disk"]
    sq_sites = torch.as_tensor(sq_mesh.sites, **dev)
    sq_areas = torch.as_tensor(sq_mesh.vertex_areas, **dev)
    sq_J = torch.as_tensor(squid_solution.film_solutions["fc_ring"].current_density, **dev)
    pts = torch.as_tensor((s_mesh.sites[None] - positions[:, None]).reshape(-1, 2), **dev)
    _scan_kernel_row(torch, kernels, cuda_kernels, "applied field maps", sq_sites, sq_areas, sq_J,
                     pts, 1.0, 1)
    s_sites = torch.as_tensor(s_mesh.sites, **dev)
    s_areas = torch.as_tensor(s_mesh.vertex_areas, **dev)
    s_J = torch.as_tensor(np.random.default_rng(3).standard_normal((s_n, 2)), **dev)
    _scan_kernel_row(torch, kernels, cuda_kernels, "back action, per position", s_sites, s_areas,
                     s_J, sq_sites + torch.as_tensor(positions[0], **dev), 1.0,
                     "2 x B per round")
    # Back action at B = 16.
    sub = positions[:: SCAN_B // BACK_ACTION_B]
    _reset_launches(cuda_kernels)
    M_back, back_s = _wall(torch, lambda: scanning.susceptibility_scan(
        sample_model=model, **{**scan, "positions": sub}, back_action=1))
    back_launches = dict(cuda_kernels.LAUNCHES)
    M_first = M[:: SCAN_B // BACK_ACTION_B]
    change = float(np.abs(M_back - M_first).max() / np.abs(M_first).max())
    print(
        f"phase13 back_action=1 at B={len(sub)}: {back_s:.4f} s, launches {back_launches}; "
        f"relative change from the first-order map {change:.3e}"
    )
    _require(bool(np.all(np.isfinite(M_back))), "back-action output")
    _require(back_launches["biot_savart_batch"] == 1 + 2 * len(sub), back_launches)
    # Magnetometry with the SQUID's screening over a Pearl vortex.
    vortex_solution = st.solve(sample, vortices=[st.Vortex(x=0.0, y=0.0, film="disk")],
                               current_units="uA", torch_device=CARD)[-1]
    _reset_launches(cuda_kernels)
    Phi, mag_s = _wall(torch, lambda: scanning.magnetometry_scan(
        vortex_solution, positions=positions, squid_height=1.0, pickup_loop="pl",
        squid_device=squid, screening=True, torch_device=CARD))
    mag_launches = dict(cuda_kernels.LAUNCHES)
    bare = scanning.magnetometry_scan(vortex_solution, positions=positions, squid_height=1.0,
                                      pickup_loop="pl", squid_device=squid, torch_device=CARD)
    mag_mirror = float(np.abs(Phi - Phi[::-1]).max() / np.abs(Phi).max())
    print(
        f"phase13 magnetometry over a Pearl vortex, screening=True, B={SCAN_B}: {mag_s:.4f} s, "
        f"launches {mag_launches}; peak {Phi.max():.4e} Phi_0 (bare loop {bare.max():.4e}); "
        f"mirror symmetry {mag_mirror:.3e}"
    )
    _require(bool(np.all(np.isfinite(Phi))), "magnetometry")
    _require(mag_launches["biot_savart_batch"] == SCAN_B, mag_launches)
    # Imaging: the 192^2 Bz map of a solved ring, inverted.
    ring = st.Device(
        "ring", layers=[st.Layer("base", Lambda=0.5, z0=0)],
        films=[st.Polygon("ring", layer="base", points=st.geometry.circle(3, points=80))],
        holes=[st.Polygon("hole", layer="base", points=st.geometry.circle(1.2, points=40))],
        length_units="um",
    )
    ring.make_mesh(min_points=2500, smooth=5)
    ring_solution = st.solve(ring, circulating_currents={"hole": "1 mA"}, current_units="mA",
                             torch_device=CARD)[-1]
    n, L, z = IMAGING_SIDE, 24.0, 0.8
    xs = np.linspace(-L / 2, L / 2, n, endpoint=False)
    dx = float(xs[1] - xs[0])
    X, Y = np.meshgrid(xs, xs)
    grid = np.column_stack([X.ravel(), Y.ravel()])
    bz = ring_solution.field_at_position(grid, zs=z, units="mT", with_units=False).reshape(n, n)
    bz_card = torch.as_tensor(bz, device=CARD)

    def invert():
        return st.imaging.invert_field_map(bz_card, dx, dx, z, field_units="mT",
                                           length_units="um", current_units="mA")

    (g_rec, jx, jy), inv_s = _wall(torch, invert)
    inv_warm = [_wall(torch, invert)[1] for _ in range(3)]
    inside = ring.films["ring"].contains_points(grid)
    mesh = ring.meshes["ring"]
    g_true = np.zeros(n * n)
    g_true[inside] = interp.interp_linear(
        mesh.spatial_index(CARD), ring_solution.film_solutions["ring"].stream, grid[inside], fill=0.0
    ).cpu().numpy()
    sel = inside.reshape(n, n)
    g_true = g_true.reshape(n, n)
    dg = np.abs((g_rec - g_rec[~sel].mean()) - g_true)[sel] / np.abs(g_true[sel]).max()
    print(
        f"phase13 invert_field_map of a {n}x{n} map ({bz_card.dtype}): cold {inv_s * 1e3:.2f} ms, warm "
        f"{[round(t * 1e3, 3) for t in inv_warm]} ms; against the solved "
        f"stream median {np.median(dg):.3e}, 95th percentile {np.percentile(dg, 95):.3e}, max "
        f"{dg.max():.3e} (limits 0.02, 0.06, 0.12: tests/test_imaging.py)"
    )
    _require(np.median(dg) < 0.02 and np.percentile(dg, 95) < 0.06 and dg.max() < 0.12, "imaging")
    # The vortex energy landscape of a dense film.
    disk = st.Device(
        "disk", layers=[st.Layer("L", Lambda=0.5, z0=0)],
        films=[st.Polygon("disk", layer="L", points=st.geometry.circle(4.0, points=160))],
        length_units="um",
    )
    disk.make_mesh(min_points=LANDSCAPE_POINTS, smooth=5)
    _reset_launches(cuda_kernels)
    landscape, ls_s = _wall(torch, lambda: st.vortex_energy_landscape(
        disk, applied_field=st.sources.ConstantField(0.1), field_units="mT", current_units="mA",
        torch_device=CARD))
    ls_launches = dict(cuda_kernels.LAUNCHES)
    k = int(np.argmin(np.linalg.norm(landscape.sites - [1.0, 0.5], axis=1)))
    x, y = landscape.sites[k]
    vortex = st.solve(disk, vortices=[st.Vortex(x=float(x), y=float(y), film="disk")],
                      current_units="mA", torch_device=CARD)[-1]
    g_core = float(vortex.film_solutions["disk"].stream[landscape.indices[k]])
    expected = 0.5 * st.ureg(f"{g_core} Phi_0 * mA").to("eV").magnitude
    ls_err = abs(landscape.self_energy[k] - expected) / abs(expected)
    F = landscape.force([[1.0, 0.5], [3.0, 0.0]])
    print(
        f"phase13 vortex_energy_landscape on {len(disk.meshes['disk'].sites)} sites (dense): "
        f"{ls_s:.3f} s, launches {ls_launches}; self-energy at ({x:.3f}, {y:.3f}) "
        f"{landscape.self_energy[k]:.6e} eV against the vortex solve's {expected:.6e} eV: "
        f"{ls_err:.3e} (limit {LANDSCAPE_TOL:.0e}); force there {F[0]} pN"
    )
    _require(ls_err <= LANDSCAPE_TOL, f"landscape self-energy {ls_err:.3e}")
    _require(bool(np.all(np.isfinite(landscape.total(1.0)))), "landscape")
    _inverse_diagonal_readoff(torch, st, disk, landscape.indices[k])
    context = dict(sample=sample, positions=positions, M=M,
                   squid_solution={"float32": squid_solution, "float64": squid64_solution})
    return launches, context


def _inverse_diagonal_readoff(torch, st, disk, site):
    """What the JAX package's landscape reads for an "inv" film, -diag(M)
    unrefined, against the refined identity solve the port takes, at the
    landscape's check site: printed, no bar (ROADMAP 3.16)."""
    from superscreen_tpu_torch.ops import linalg

    model = st.factorize_model(device=disk, current_units="mA", torch_device=CARD)
    system = model.film_systems["disk"]
    if linalg.factor_kind(system.lu_piv) != "inv":
        print(f"phase13 landscape film factorized as {linalg.factor_kind(system.lu_piv)!r}")
        return
    j = int(np.searchsorted(system.indices, site))
    e = torch.zeros((len(system.indices), 1), dtype=system.A.dtype, device=CARD)
    e[j] = 1.0
    refined = float(linalg.lu_solve_refined(system.A, system.lu_piv, e)[j, 0])
    read = float(system.lu_piv[1][j, j])
    print(
        f"phase13 landscape film 'inv' (ni={len(system.indices)}): -diag(M) read off at the check "
        f"site against the refined identity solve {abs(read - refined) / abs(refined):.3e}"
    )


def _weak_spot_lambda(x, y):
    """The hidden Gaussian weak spot of examples/susceptibility_inversion.py."""
    return 0.3 + 1.2 * np.exp(-((x - 1.0) ** 2 + (y + 0.5) ** 2) / 0.5)


def _adjoint_kernel_rows(torch, kernels, cuda_kernels, device, sample_sites, launches):
    """q_matrix in float64 on a stack film's sites and on the config-5
    sample's (``sample_sites``), held against q_matrix_plain, and
    biot_savart_batch at the adjoint's coupling shapes (forward B = 1; VJP:
    roles swapped, two columns), timed beside their bounds; the VJP on the
    kernel held against plain autograd through biot_savart_plain."""
    from superscreen_tpu_torch.ops import autograd

    meshes = list(device.meshes.values())
    rng = np.random.default_rng(14)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        dev = dict(dtype=dtype, device=CARD)
        src = torch.as_tensor(meshes[0].sites, **dev)
        dst = torch.as_tensor(meshes[1].sites, **dev)
        areas = torch.as_tensor(meshes[0].vertex_areas, **dev)
        n1, n2 = src.shape[0], dst.shape[0]
        J = torch.as_tensor(rng.standard_normal((1, n1, 2)), **dev).requires_grad_()
        g = torch.as_tensor(rng.standard_normal((1, n2)), **dev)
        (vjp,) = torch.autograd.grad(autograd.BiotSavartCoupling.apply(J, src, areas, dst, 0.25), J, g)
        (plain,) = torch.autograd.grad(kernels.biot_savart_plain(src, areas, J, dst, 0.25), J, g)
        abs_err, rel = _check_against_plain(torch, f"phase14 coupling VJP {name}", dtype, vjp, plain)
        del plain
        print(
            f"phase14 coupling VJP on the kernel against plain autograd, {n1} -> {n2} sites, "
            f"{name}: max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL[name]:.0e})"
        )
        ones = torch.ones(n2, **dev)
        probe = torch.as_tensor(rng.standard_normal((2, n2, 2)), **dev)
        for label, args, cols in (
            ("forward", (src, areas, J.detach(), dst, 0.25), 1),
            ("VJP (swapped, 2 columns)", (dst, ones, probe, src, 0.25), 2),
        ):
            ms = _timed(torch, lambda: cuda_kernels.biot_savart_batch(*args), 10)
            plain_ms = _timed(torch, lambda: kernels.biot_savart_plain(*args), 3)
            bound = _bound("biot_savart_batch", dtype, args[3].shape[0], args[0].shape[0], cols)
            print(
                f"phase14 biot_savart_batch {label} {args[0].shape[0]} -> {args[3].shape[0]}, "
                f"B={cols} {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"{_bound_text(bound, ms)}; launches per forward + backward "
                f"{launches['biot_savart_batch']}"
            )
    for sites in (meshes[0].sites, sample_sites):
        n = len(sites)
        pts = torch.as_tensor(sites, dtype=torch.float64, device=CARD)
        abs_err, rel = _check_against_plain(
            torch, f"phase14 q_matrix n={n} float64", torch.float64,
            cuda_kernels.q_matrix(pts), kernels.q_matrix_plain(pts),
        )
        ms = _timed(torch, lambda: cuda_kernels.q_matrix(pts), 5)
        plain_ms = _timed(torch, lambda: kernels.q_matrix_plain(pts), 2)
        bound = _bound("q_matrix", torch.float64, n, n, 0)
        print(
            f"phase14 q_matrix n={n} float64: max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit "
            f"{TOL['float64']:.0e}); kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"{_bound_text(bound, ms)}; launches per model build {launches['q_matrix']}"
        )
    torch.cuda.empty_cache()


def _adjoint_stack_run(torch, st, cuda_kernels, device, label):
    """The adjoint model of the stack with phase 2's drive (1 mT, 1 mA in
    the outer ring's hole, ITERATIONS rounds): returns the model, its
    forward function, its parameters, and the build's launches."""
    _reset_launches(cuda_kernels)
    model, build_s = _wall(torch, lambda: st.build_adjoint_model(
        device, field_units="mT", current_units="uA", torch_device=CARD))
    build_launches = dict(cuda_kernels.LAUNCHES)
    _require(build_launches["q_matrix"] == len(device.films), build_launches)
    params = model.default_params(applied_field=st.sources.ConstantField(1.0))
    params["circulating_currents"]["hole0"] = torch.tensor(1000.0, dtype=model.dtype, device=CARD)
    interior = {name: len(data.interior) for name, data in model.films.items()}
    print(
        f"{label} build_adjoint_model: {build_s:.3f} s, launches {build_launches}; "
        f"interior unknowns {interior}"
    )
    return model, model.forward_fn(ITERATIONS), params, build_launches


def _adjoint_loss(torch, forward, params, film, lam):
    out = forward({**params, "Lambda": {**params["Lambda"], film: lam}})
    return sum(torch.sum(fields["self_field"] ** 2) for fields in out.values()), out


def _forward_backward(torch, cuda_kernels, forward, params, film, label):
    """One forward and one backward pass of sum(self_field^2) with respect
    to one film's Lambda, each timed (synchronised) with its launches."""
    lam = params["Lambda"][film].clone().requires_grad_()
    _reset_launches(cuda_kernels)
    (loss, out), fwd_s = _wall(torch, lambda: _adjoint_loss(torch, forward, params, film, lam))
    fwd_launches = dict(cuda_kernels.LAUNCHES)
    _reset_launches(cuda_kernels)
    (grad,), bwd_s = _wall(torch, lambda: torch.autograd.grad(loss, lam))
    bwd_launches = dict(cuda_kernels.LAUNCHES)
    print(
        f"{label}: forward {fwd_s * 1e3:.1f} ms, launches {fwd_launches}; backward "
        f"{bwd_s * 1e3:.1f} ms, launches {bwd_launches}"
    )
    _require(bwd_launches["biot_savart_batch"] > 0, f"{label}: backward launched no kernel")
    _require(bool(torch.isfinite(grad).all()), f"{label}: gradient")
    return out, grad, fwd_launches, bwd_launches


def _stream_errors(out, streams):
    return max(
        float(np.abs(out[name]["stream"].detach().double().cpu().numpy() - ref).max()
              / np.abs(ref).max())
        for name, ref in streams.items()
    )


def phase_adjoint(torch, st, kernels, cuda_kernels, device, streams32, scan):
    """Phase 14: the differentiable solve.  The four-ring stack of phase 2
    (float32 against phase 2's solve(), float64 against a float64 solve()
    on the card, a directional derivative against a central difference,
    two backward passes bit for bit, the coupling VJP against plain
    autograd) and config 5 with a hidden weak spot in the sample's Lambda
    (build_scan_forward against susceptibility_scan in float32 and float64,
    the misfit gradient against a central difference, and ADAM_STEPS Adam
    steps from a uniform guess).  Returns the launch counts of the float32
    stack's forward and backward passes."""
    from superscreen_tpu_torch.squids import scanning

    film = "ring1"
    # Float32 stack.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, forward, params, build_launches = _adjoint_stack_run(
        torch, st, cuda_kernels, device, "phase14 float32 stack"
    )
    out, grad32, fwd_launches, bwd_launches = _forward_backward(
        torch, cuda_kernels, forward, params, film, "phase14 float32 stack (cold)"
    )
    err32 = _stream_errors(out, streams32)
    out32 = {name: {"stream": fields["stream"].detach().cpu()} for name, fields in out.items()}
    grad32 = grad32.double().cpu()
    del out  # its graph holds the call's factorizations
    _forward_backward(torch, cuda_kernels, forward, params, film, "phase14 float32 stack (warm)")
    lam = params["Lambda"][film].clone().requires_grad_()
    _profile(torch, lambda: _wall(torch, lambda: torch.autograd.grad(
        _adjoint_loss(torch, forward, params, film, lam)[0], lam))[1],
        "phase14 profile of a float32 stack forward + backward", top=14)
    print(
        f"phase14 float32 forward against phase 2's solve(): {err32:.3e} (limit {ADJ_F32_MAX:.0e}); "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB"
    )
    _require(err32 <= ADJ_F32_MAX, f"float32 adjoint streams {err32:.3e}")
    # Every coupling pass has a VJP but the first round's from the three
    # films whose Lambda is not differentiated.
    pairs = len(device.films) * (len(device.films) - 1)
    _require(fwd_launches["biot_savart_batch"] == pairs * ITERATIONS, fwd_launches)
    _require(
        bwd_launches["biot_savart_batch"] == pairs * (ITERATIONS - 1) + len(device.films) - 1,
        bwd_launches,
    )
    del model, forward, params
    torch.cuda.empty_cache()
    # Float64 solve() on the card, then the float64 adjoint model.
    device64 = device.copy()
    device64.solve_dtype = "float64"
    sol64 = st.solve(device64, applied_field=st.sources.ConstantField(1.0), current_units="uA",
                     circulating_currents={"hole0": "1 mA"}, iterations=ITERATIONS,
                     coupling="exact", torch_device=CARD)[-1]
    streams64 = {name: fs.stream for name, fs in sol64.film_solutions.items()}
    del sol64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, forward, params, _ = _adjoint_stack_run(
        torch, st, cuda_kernels, device64, "phase14 float64 stack"
    )
    out, grad, _, _ = _forward_backward(torch, cuda_kernels, forward, params, film,
                                        "phase14 float64 stack (cold)")
    err64 = _stream_errors(out, streams64)
    del out
    grad_err32 = float((grad32.to(CARD) - grad).abs().max() / grad.abs().max())
    print(
        f"phase14 against the float64 solve(): the float32 adjoint forward "
        f"{_stream_errors(out32, streams64):.3e}, phase 2's float32 solve() "
        f"{_stream_errors({k: {'stream': torch.as_tensor(v)} for k, v in streams32.items()}, streams64):.3e}; "
        f"the float32 gradient against the float64 one: {grad_err32:.3e} of max|grad| "
        f"(limit {ADJ_GRAD32_MAX:.0e})"
    )
    _, grad_again, _, _ = _forward_backward(torch, cuda_kernels, forward, params, film,
                                            "phase14 float64 stack (warm)")
    same = bool(torch.equal(grad, grad_again))
    lam = params["Lambda"][film].clone().requires_grad_()
    _profile(torch, lambda: _wall(torch, lambda: torch.autograd.grad(
        _adjoint_loss(torch, forward, params, film, lam)[0], lam))[1],
        "phase14 profile of a float64 stack forward + backward", top=14)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(grad.shape[0]), dtype=grad.dtype,
                        device=CARD)
    lam0 = params["Lambda"][film]
    with torch.no_grad():
        (up, _), (down, _) = (_adjoint_loss(torch, forward, params, film, lam0 + s * ADJ_FD_EPS * v)
                              for s in (1, -1))
    fd = float((up - down) / (2 * ADJ_FD_EPS))
    ad = float(torch.dot(grad, v))
    fd_err = abs(fd - ad) / abs(ad)
    print(
        f"phase14 float64 forward against a float64 solve() on the card: {err64:.3e} (limit "
        f"{ADJ_F64_MAX:.0e}); directional derivative {ad:.10e} against the central difference "
        f"{fd:.10e}: {fd_err:.3e} (limit {ADJ_FD_MAX:.0e}); two backward passes bitwise equal: "
        f"{same}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB"
    )
    _require(err64 <= ADJ_F64_MAX, f"float64 adjoint streams {err64:.3e}")
    _require(fd_err <= ADJ_FD_MAX, f"directional derivative {fd_err:.3e}")
    _require(same, "two backward passes differ")
    _require(grad_err32 <= ADJ_GRAD32_MAX, f"float32 gradient {grad_err32:.3e}")
    del model, forward, params, grad, grad_again, grad32
    torch.cuda.empty_cache()
    _adjoint_kernel_rows(
        torch, kernels, cuda_kernels, device, scan["sample"].meshes["disk"].sites,
        dict(q_matrix=build_launches["q_matrix"],
             biot_savart_batch=fwd_launches["biot_savart_batch"] + bwd_launches["biot_savart_batch"]),
    )
    # Config 5 with a weak spot in the sample's Lambda.
    for dtype in ("float64", "float32"):
        sample = scan["sample"].copy()
        sample.layers["s"].Lambda = st.Parameter(_weak_spot_lambda)
        sample.solve_dtype = dtype
        squid_solution = scan["squid_solution"][dtype]
        kw = dict(positions=scan["positions"], squid_height=1.0, pickup_loop="pl", I_fc="1 mA")
        measured = scanning.susceptibility_scan(
            sample, squid_solution=squid_solution, torch_device=CARD, **kw)
        _reset_launches(cuda_kernels)
        (model, scan_fn), build_s = _wall(torch, lambda: scanning.build_scan_forward(
            sample, squid_solution, torch_device=CARD, **kw))
        build_launches = dict(cuda_kernels.LAUNCHES)
        params = model.default_params()
        chi, scan_s = _wall(torch, lambda: scan_fn(params))
        err = float(np.abs(chi.detach().cpu().numpy() - measured).max() / np.abs(measured).max())
        print(
            f"phase14 build_scan_forward {dtype} (B={len(scan['positions'])}, sample "
            f"{model.films['disk'].n} sites, {len(model.films['disk'].interior)} interior): "
            f"build {build_s:.3f} s, launches {build_launches}; "
            f"scan_fn {scan_s * 1e3:.1f} ms; against susceptibility_scan {err:.3e} "
            f"(limit {ADJ_SCAN_MAX[dtype]:.0e})"
        )
        _require(err <= ADJ_SCAN_MAX[dtype], f"scan_fn {dtype} {err:.3e}")
        _require(build_launches["biot_savart_batch"] == 1 and build_launches["q_matrix"] == 1,
                 build_launches)
        target = torch.as_tensor(measured, dtype=model.dtype, device=CARD)
        n = model.films["disk"].n

        def misfit(lam):
            chi = scan_fn({**params, "Lambda": {"disk": lam}})
            return torch.mean((chi - target) ** 2)

        if dtype == "float64":
            lam = torch.full((n,), ADAM_GUESS, dtype=model.dtype, device=CARD, requires_grad=True)
            (grad,) = torch.autograd.grad(misfit(lam), lam)
            v = torch.as_tensor(np.random.default_rng(1).standard_normal(n), dtype=model.dtype,
                                device=CARD)
            with torch.no_grad():
                fd = float((misfit(lam + ADJ_FD_EPS * v) - misfit(lam - ADJ_FD_EPS * v))
                           / (2 * ADJ_FD_EPS))
            ad = float(torch.dot(grad, v))
            fd_err = abs(fd - ad) / abs(ad)
            print(
                f"phase14 scan misfit gradient at a uniform Lambda = {ADAM_GUESS}: directional "
                f"derivative {ad:.10e} against the central difference {fd:.10e}: {fd_err:.3e} "
                f"(limit {ADJ_FD_MAX:.0e})"
            )
            _require(fd_err <= ADJ_FD_MAX, f"scan misfit gradient {fd_err:.3e}")
            continue
        lam = torch.full((n,), ADAM_GUESS, dtype=model.dtype, device=CARD, requires_grad=True)
        loss, fwd_s = _wall(torch, lambda: misfit(lam))
        _reset_launches(cuda_kernels)
        _, bwd_s = _wall(torch, lambda: torch.autograd.grad(loss, lam))
        print(
            f"phase14 scan misfit {dtype}: forward {fwd_s * 1e3:.1f} ms, backward "
            f"{bwd_s * 1e3:.1f} ms, backward launches {dict(cuda_kernels.LAUNCHES)}"
        )
        _profile(torch, lambda: _wall(torch, lambda: torch.autograd.grad(misfit(lam), lam))[1],
                 "phase14 profile of a float32 scan misfit forward + backward")
        opt = torch.optim.Adam([lam], lr=ADAM_LR)
        losses, step_s = [], []
        for _ in range(ADAM_STEPS):

            def step():
                opt.zero_grad()
                loss = misfit(lam)
                loss.backward()
                opt.step()
                with torch.no_grad():
                    lam.clamp_(0.05, 5.0)
                return float(loss.detach())

            loss, seconds = _wall(torch, step)
            losses.append(loss)
            step_s.append(seconds)
        with torch.no_grad():
            final = float(misfit(lam))
        print(
            f"phase14 Adam on the sample's Lambda ({dtype}, lr {ADAM_LR}, from {ADAM_GUESS}): "
            f"misfit {[f'{x:.4e}' for x in losses]} -> {final:.4e}; ms per step "
            f"{[round(t * 1e3, 1) for t in step_s]}"
        )
        _require(final < losses[0], f"the misfit did not fall: {losses} -> {final}")
    return fwd_launches, bwd_launches


def _relative_stream_error(solution, streams):
    """Largest over the films of ``max|g - g_ref| / max|g_ref|``, with
    ``streams`` the reference ``{film: stream}``."""
    return max(
        float(
            np.abs(solution.film_solutions[name].stream.astype(np.float64) - ref).max()
            / np.abs(ref).max()
        )
        for name, ref in ((k, v.astype(np.float64)) for k, v in streams.items())
    )


def _remesh_timed(device):
    """Meshes ``device`` as phase 2's stack was meshed; returns the wall
    seconds."""
    t0 = time.perf_counter()
    device.make_mesh(min_points=SITES_DENSE)
    return time.perf_counter() - t0


def phase_transforms(torch, st, kernels, cuda_kernels, device, reference):
    """Phase 15: the host conveniences on phase 2's stack (``device``, whose
    final Solution is ``reference``): the public ``distance.q_matrix``
    against the kernel route, ``translate`` (which keeps the mesh), the
    mesh cache with ``mirror_layers``, ``rotate``, ``solve(return_solutions
    =False, progress_bar=True)``, the provenance dict, and an HDF5 round
    trip of a model and a solution where h5py and dill are installed.
    Returns the launch counts of the translated stack's factorize and
    solve."""
    import importlib.util
    import shutil
    import tempfile

    ref_streams = {name: fs.stream for name, fs in reference.film_solutions.items()}
    sites = device.meshes["ring0"].sites
    # distance.q_matrix: NumPy in and out, on the q_matrix kernel.
    _reset_launches(cuda_kernels)
    out, wall_s = _wall(
        torch, lambda: st.distance.q_matrix(sites, dtype=np.float32, torch_device=CARD)
    )
    public_launches = cuda_kernels.LAUNCHES["q_matrix"]
    def kernel_route():
        return kernels.q_matrix(torch.as_tensor(sites, dtype=torch.float32, device=CARD))

    route = kernel_route()
    same = bool(torch.equal(torch.from_numpy(out), route.cpu()))
    del out
    ms = _timed(torch, kernel_route, 3)
    del route
    print(
        f"phase15 distance.q_matrix n={len(sites)} float32: bitwise equal to the kernel route "
        f"{same}; launches {public_launches}; public call with the host copy "
        f"{wall_s * 1e3:.1f} ms wall; kernel route {ms:.3f} ms (CUDA events)"
    )
    _require(same and public_launches == 1, "distance.q_matrix is not the q_matrix kernel")
    # distance.cdist and MeshOperators.C_vector compute on the card by
    # default.  C diverges where x - mean(x) = +-a, at sites that a rounding
    # of the centroid moves, so C_vector takes 2^14 points of a dyadic
    # grid, whose centroid is exact in any summation order, and is held
    # entry by entry.
    grid = np.random.default_rng(15).integers(-400, 400, (2**14, 2)) / 8
    got, want = (st.distance.cdist(sites[:4096], sites[:2048], torch_device=d) for d in (CARD, "cpu"))
    worst = float(np.abs(got - want).max() / np.abs(want).max())
    got, want = (st.MeshOperators.C_vector(grid, torch_device=d) for d in (CARD, "cpu"))
    worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
    print(f"phase15 distance.cdist and MeshOperators.C_vector, card against CPU: {worst:.3e} (limit 1e-12)")
    _require(worst <= 1e-12, f"cdist / C_vector on the card {worst:.3e}")

    # translate keeps (and shifts) the mesh.
    errors = {}
    for shift in ((3.0, -2.0), (50.0, 50.0)):
        moved = device.translate(*shift)
        model, solutions, launches = _factorize_and_solve(
            torch, st, cuda_kernels, moved, f"phase15 translate{shift}"
        )
        if shift == (3.0, -2.0):
            transform_launches = launches
        errors[shift] = _relative_stream_error(solutions[-1], ref_streams)
        del model, solutions, moved
        torch.cuda.empty_cache()
    print(
        f"phase15 translated streams against phase 2's (max|dg| / max|g| per film): "
        f"(3, -2): {errors[(3.0, -2.0)]:.3e} (limit {STREAM_REL_MAX}); "
        f"(50, 50): {errors[(50.0, 50.0)]:.3e} (no limit)"
    )
    _require(errors[(3.0, -2.0)] <= STREAM_REL_MAX, f"translated streams {errors}")

    # The mesh cache, on a fresh stack and its mirror image.
    cache = tempfile.mkdtemp(prefix="mesh_cache_")
    try:
        with _environ(SUPERSCREEN_TPU_MESH_CACHE=cache):
            fresh = device.copy(with_mesh=False)
            miss_s = _remesh_timed(fresh)
            stored = sorted(os.listdir(cache))
            mirrored = fresh.mirror_layers()
            hit_s = _remesh_timed(mirrored)
            hit = sorted(os.listdir(cache)) == stored and all(
                np.array_equal(mirrored.meshes[k].sites, fresh.meshes[k].sites)
                and np.array_equal(mirrored.meshes[k].elements, fresh.meshes[k].elements)
                for k in fresh.films
            )
            same_as_phase2 = all(
                np.array_equal(fresh.meshes[k].sites, device.meshes[k].sites) for k in device.films
            )
        print(
            f"phase15 mesh cache: miss {miss_s:.3f} s ({len(stored)} entries stored), "
            f"mirror_layers() hit {hit_s:.3f} s, identical arrays {hit}; the miss's meshes "
            f"equal phase 2's: {same_as_phase2}"
        )
        _require(hit and len(stored) == len(device.films), "mesh cache did not hit")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    model, solutions, _ = _factorize_and_solve(torch, st, cuda_kernels, mirrored, "phase15 mirror")
    err = _relative_stream_error(solutions[-1], ref_streams)
    bitwise = all(
        np.array_equal(solutions[-1].film_solutions[k].stream, v) for k, v in ref_streams.items()
    )
    print(
        f"phase15 mirrored streams against phase 2's: {err:.3e} (limit 1e-6); "
        f"bitwise equal {bitwise}"
    )
    _require(err <= 1e-6, f"mirrored streams {err:.3e}")
    del model, solutions, mirrored, fresh
    torch.cuda.empty_cache()

    # rotate: a new mesh of the same geometry; the hole fluxoids agree.
    rotated = device.rotate(90)
    print(f"phase15 rotate(90) re-mesh: {_remesh_timed(rotated):.3f} s")
    model, solutions, _ = _factorize_and_solve(torch, st, cuda_kernels, rotated, "phase15 rotate")
    worst = 0.0
    for hole in device.holes:
        want = sum(reference.hole_fluxoid(hole)).to("Phi_0").magnitude
        got = sum(solutions[-1].hole_fluxoid(hole)).to("Phi_0").magnitude
        worst = max(worst, abs(got - want) / abs(want))
        print(f"phase15 rotate(90) {hole} fluxoid {got:.6f} Phi_0 (phase 2: {want:.6f})")
    print(f"phase15 rotated hole fluxoids: largest relative difference {worst:.3e} (limit 1e-2)")
    _require(worst <= 1e-2, f"rotated fluxoids {worst:.3e}")
    nothing = st.solve(
        model=model, applied_field=st.sources.ConstantField(1.0), iterations=ITERATIONS,
        return_solutions=False, progress_bar=True, torch_device=CARD,
    )
    print(
        f"phase15 solve(return_solutions=False, progress_bar=True) returned {nothing!r} "
        f"(tqdm installed: {importlib.util.find_spec('tqdm') is not None})"
    )
    _require(nothing is None, "return_solutions=False returned something")
    print(f"phase15 version_dict: {json.dumps(st.version_dict())}")

    # HDF5 needs h5py and dill.
    missing = [m for m in ("h5py", "dill") if importlib.util.find_spec(m) is None]
    if missing:
        print(f"phase15 HDF5 round trip not run on the card: {', '.join(missing)} not installed")
    else:
        import h5py

        folder = tempfile.mkdtemp(prefix="hdf5_")
        try:
            path = os.path.join(folder, "model.h5")
            with h5py.File(path, "w") as f:
                model.to_hdf5(f)
            with h5py.File(path, "r") as f:
                loaded = st.FactorizedModel.from_hdf5(f, torch_device=CARD)
            again, _ = _solve(torch, st, loaded)
            bitwise = all(
                np.array_equal(a.film_solutions[k].stream, b.film_solutions[k].stream)
                for a, b in zip(solutions, again) for k in device.films
            )
            solutions[-1].to_hdf5(os.path.join(folder, "solution.h5"))
            back = st.Solution.from_hdf5(os.path.join(folder, "solution.h5"), torch_device=CARD)
            print(
                f"phase15 HDF5: reloaded model's streams bitwise equal {bitwise}; "
                f"solution round trip equals {back.equals(solutions[-1])}"
            )
            _require(bitwise and back.equals(solutions[-1]), "HDF5 round trip")
            del loaded, again, back
        finally:
            shutil.rmtree(folder, ignore_errors=True)
    del model, solutions, rotated
    torch.cuda.empty_cache()
    return transform_launches


def _cold_native_build(native):
    """Compiles the geometry core from its source once more, into a file
    of its own (the process loaded its library at first use, when phase 2
    meshed); returns the compiler's first ``--version`` line and the build
    seconds."""
    cxx = native.compiler()
    version = subprocess.run(
        [cxx, "--version"], capture_output=True, text=True, check=True
    ).stdout.splitlines()[0]
    target = native._BUILD_DIR / f"libgeomcore_cold_{os.getpid()}.so"
    t0 = time.perf_counter()
    native._build(cxx, target)
    seconds = time.perf_counter() - t0
    target.unlink()
    return version, seconds


def _mesh_rows(elements):
    return set(map(tuple, np.sort(elements, axis=1).tolist()))


def _remesh_profiled(device):
    """Re-meshes a copy of ``device`` as phase 2 meshed it, under cProfile;
    returns the copy, the profiled wall seconds and the five entries with
    the most time of their own."""
    import cProfile
    import pstats

    fresh = device.copy(with_mesh=False)
    profiler = cProfile.Profile()
    profiler.enable()
    seconds = _remesh_timed(fresh)
    profiler.disable()
    stats = pstats.Stats(profiler)
    top = sorted(stats.stats.items(), key=lambda item: -item[1][2])[:5]
    lines = [
        f"{tottime:8.3f} s own {cumtime:8.3f} s cumulative x{ncalls:<7d} "
        f"{os.path.basename(path)}:{line} {func}"
        for (path, line, func), (_, ncalls, tottime, cumtime, _) in top
    ]
    return fresh, seconds, lines


def _ring_test_inputs(n_vertices, n_points):
    """A closed wavy outline of ``n_vertices`` vertices and ``n_points``
    query points around it, plus every vertex and a point at a dyadic
    fraction of every edge (points on the outline)."""
    rng = np.random.default_rng(16)
    t = np.linspace(0, 2 * np.pi, n_vertices, endpoint=False)
    r = 3.0 + 0.3 * np.sin(7 * t)
    ring = np.stack([r * np.cos(t), r * np.sin(t)], axis=1)
    ring = np.concatenate([ring, ring[:1]])
    frac = rng.integers(1, 8, size=(n_vertices, 1)) / 8
    on_outline = np.concatenate([ring[:-1], ring[:-1] + frac * (ring[1:] - ring[:-1])])
    queries = np.concatenate([rng.uniform(-3.5, 3.5, (n_points, 2)), on_outline])
    return ring, queries, len(on_outline)


def _solve_film_call(torch, st, cuda_kernels, label, device, model, solution, name,
                     film_info=None, **extra):
    """``solve_film`` for film ``name`` of ``model`` with the applied field
    and the field from the other films of ``solution``'s film (in solver
    units), its launches (counts set to 0 just before) and its CUDA-event
    milliseconds; returns the film solution, the launches and the ms."""
    import importlib

    from superscreen_tpu_torch.solver.utils import field_conversion_factor
    from superscreen_tpu_torch.sweep import vortex_flux_quantum

    solve_film = importlib.import_module("superscreen_tpu_torch.solver.solve_film").solve_film
    conv = field_conversion_factor(
        "mT", model.current_units, length_units=device.length_units, ureg=device.ureg
    ).magnitude
    fs = solution.film_solutions[name]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _reset_launches(cuda_kernels)
    start.record()
    out = solve_film(
        device=device,
        applied_field=fs.applied_field * conv,
        film_info=model.film_info[name] if film_info is None else film_info,
        film_system=model.film_systems[name],
        hole_systems=model.hole_systems[name],
        field_conversion=conv,
        vortex_flux=vortex_flux_quantum(device, model.current_units),
        terminal_systems=model.terminal_systems.get(name),
        field_from_other_films=fs.field_from_other_films * conv,
        **extra,
    )
    stop.record()
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.LAUNCHES)
    ms = start.elapsed_time(stop)
    print(f"{label} solve_film({name!r}) launches {launches} ms={ms:.2f} (CUDA events)")
    for arr in (out.stream, out.current_density, out.self_field):
        _require(np.all(np.isfinite(arr)), f"{label} {name}: non-finite solve_film output")
    return out, launches, ms


def _check_film(label, name, out, fs, limit):
    """Stream and self-field of ``out`` against the film solution ``fs``,
    relative to each one's max|.|; both at most ``limit``."""
    errors = {
        quantity: float(
            np.abs(getattr(out, quantity).astype(np.float64) - getattr(fs, quantity)).max()
            / np.abs(getattr(fs, quantity)).max()
        )
        for quantity in ("stream", "self_field")
    }
    print(f"{label} {name}: against solve()'s last round {errors} (limit {limit:.0e})")
    _require(max(errors.values()) <= limit, f"{label} {name}: solve_film {errors}")


def phase_native_solve_film(torch, st, cuda_kernels, device, large, transport, post_times):
    """Phase 16: the geometry core and ``solve_film`` on the card's machine
    (see the module docstring)."""
    import logging
    import shutil
    import tempfile

    from superscreen_tpu_torch import native
    from superscreen_tpu_torch.device.polygon import points_in_ring_plain
    from superscreen_tpu_torch.solver import refine
    from superscreen_tpu_torch.solver.utils import make_film_info

    # 1. The build.
    version, cold_s = _cold_native_build(native)
    print(
        f"phase16 geometry core: compiler {native.compiler()} ({version}); first-use build "
        f"{native.STATS['build_seconds']} s, cold rebuild {cold_s:.3f} s"
    )

    # 2. Phase 2's stack re-meshed by the core (profiled) and by the plain
    # routes; both give phase 2's meshes.
    fresh, native_s, top = _remesh_profiled(device)
    unprofiled = device.copy(with_mesh=False)
    native_plain_s = _remesh_timed(unprofiled)
    with _environ(SUPERSCREEN_TPU_NATIVE="0"):
        plain = device.copy(with_mesh=False)
        plain_s = _remesh_timed(plain)
    same_native = all(
        np.array_equal(m.meshes[k].sites, device.meshes[k].sites)
        and np.array_equal(m.meshes[k].elements, device.meshes[k].elements)
        for m in (fresh, unprofiled) for k in device.films
    )
    same_plain = all(
        np.array_equal(plain.meshes[k].sites, device.meshes[k].sites)
        and _mesh_rows(plain.meshes[k].elements) == _mesh_rows(device.meshes[k].elements)
        for k in device.films
    )
    print(
        f"phase16 re-mesh of phase 2's stack ({sum(len(m.sites) for m in device.meshes.values())} "
        f"sites): geometry core {native_plain_s:.3f} s ({native_s:.3f} s under cProfile), "
        f"plain routes (SUPERSCREEN_TPU_NATIVE=0) {plain_s:.3f} s; core meshes equal phase 2's "
        f"bit for bit {same_native}; plain meshes the same sites and triangle sets {same_plain}; "
        f"Delaunay fallbacks {native.STATS['delaunay_fallbacks']}"
    )
    for line in top:
        print(f"phase16 cProfile (core re-mesh) {line}")
    _require(same_native and same_plain, "re-meshed stacks differ from phase 2's")
    del fresh, unprofiled, plain

    # 3. The ring test, bit for bit against the NumPy loop.
    ring, queries, n_outline = _ring_test_inputs(RING_TEST_VERTICES, RING_TEST_POINTS)
    got, core_s = _wall(torch, lambda: native.points_in_ring(ring, queries))
    subset = np.concatenate([queries[:RING_TEST_PLAIN_POINTS], queries[-n_outline:]])
    want, plain_s = _wall(torch, lambda: points_in_ring_plain(ring, subset))
    same = np.array_equal(np.concatenate([got[:RING_TEST_PLAIN_POINTS], got[-n_outline:]]), want)
    print(
        f"phase16 points_in_ring, {RING_TEST_VERTICES}-vertex outline: core {len(queries)} points "
        f"in {core_s * 1e3:.1f} ms ({core_s / len(queries) * 1e9:.1f} ns per point); plain "
        f"{len(subset)} of them (every vertex and edge point among them) in {plain_s:.3f} s "
        f"({plain_s / len(subset) * 1e9:.0f} ns per point); bitwise equal {same}; "
        f"{int(got.sum())} inside"
    )
    _require(same, "points_in_ring differs from points_in_ring_plain")

    # 4. The arguments of fault 3.13, through the mesh cache.
    cache = tempfile.mkdtemp(prefix="mesh_cache_")
    try:
        with _environ(SUPERSCREEN_TPU_MESH_CACHE=cache):
            t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
            disk_points = np.stack([2 * np.cos(t), 2 * np.sin(t)], axis=1)
            disks = [
                st.Device("disk", layers=[st.Layer("base", Lambda=0.1)],
                          films=[st.Polygon("disk", layer="base", points=disk_points)])
                for _ in range(2)
            ]
            kwargs = dict(max_edge_length=0.4, min_angle=30, extra_points=[[0.1, 0.2]])
            miss_s = _wall(torch, lambda: disks[0].make_mesh(**kwargs))[1]
            stored = sorted(os.listdir(cache))
            hit_s = _wall(torch, lambda: disks[1].make_mesh(**kwargs))[1]
            hit = sorted(os.listdir(cache)) == stored and np.array_equal(
                disks[0].meshes["disk"].elements, disks[1].meshes["disk"].elements
            )
        inside = st.fem.in_polygon(disk_points, [[2, 0]], radius=0.01)
        print(
            f"phase16 make_mesh({kwargs}): {len(disks[0].meshes['disk'].sites)} sites, miss "
            f"{miss_s * 1e3:.1f} ms ({len(stored)} entry), hit {hit_s * 1e3:.1f} ms, identical "
            f"{hit}; fem.in_polygon(disk, [[2, 0]], radius=0.01) = {inside}"
        )
        _require(hit and len(stored) == 1 and inside is True, "fault 3.13 calls")
    finally:
        shutil.rmtree(cache, ignore_errors=True)

    # 5. solve_film against solve()'s last round: the dense stack (each
    # film with its dense kernel), check_inversion, hp_system against a
    # float64 solve(), the terminal strip and a low-memory film.
    totals = {key: 0 for key in cuda_kernels.LAUNCHES}

    def count(launches):
        for key, value in launches.items():
            totals[key] += value

    model, solutions, _ = _factorize_and_solve(torch, st, cuda_kernels, device, "phase16 dense")
    last = solutions[-1]
    # The dense self-field summed in float64: residual_f64 on Q diag(w)
    # with the six rounds' streams (solve()) and with one (solve_film).
    from superscreen_tpu_torch.ops import kernels

    Qw = model.film_data["ring0"].Qw
    n = Qw.shape[0]
    for k in (6, 1):
        # As _self_field_batch passes them: the float32 streams' transpose
        # read in place, no H, the result rounded to float32.
        G = torch.as_tensor(np.random.default_rng(k).standard_normal((k, n)), dtype=torch.float32,
                            device=CARD)
        ms = _timed(torch, lambda: kernels.residual_f64(Qw, G.T, out_dtype=torch.float32), 10)
        print(
            f"phase16 residual_f64 as the dense self-field, n={n} k={k}: kernel_ms={ms:.4f} "
            f"{_bound_text(_residual_bound(n, n, k, x_size=4, h_size=0, r_size=4), ms)}"
        )
    del G
    for name in device.films:
        info = make_film_info(
            device=device, circulating_currents=model.circulating_currents,
            torch_device=CARD, films=[name],
        )[name]
        out, launches, _ = _solve_film_call(
            torch, st, cuda_kernels, "phase16 dense", device, model, last, name, film_info=info,
        )
        count(launches)
        _require(launches["residual_f64"] >= 2, launches)
        _check_film("phase16 dense", name, out, last.film_solutions[name], SOLVE_FILM_REL_MAX)
        del info
    warnings = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger("solve").addHandler(handler)
    try:
        _solve_film_call(
            torch, st, cuda_kernels, "phase16 check_inversion", device, model, last, "ring0",
            check_inversion=True,
        )
    finally:
        logging.getLogger("solve").removeHandler(handler)
    print(f"phase16 check_inversion=True: warnings {warnings}")
    hp, hp_s = _wall(
        torch,
        lambda: refine.build_hp_system(device, model.film_info["ring0"], model.film_systems["ring0"]),
    )
    device64 = device.copy()
    device64.solve_dtype = "float64"
    model64, solutions64, _ = _factorize_and_solve(
        torch, st, cuda_kernels, device64, "phase16 float64"
    )
    out, launches, _ = _solve_film_call(
        torch, st, cuda_kernels, "phase16 hp_system", device, model, solutions64[-1], "ring0",
        hp_system=hp,
    )
    count(launches)
    print(f"phase16 build_hp_system('ring0'): {hp_s:.3f} s")
    _check_film("phase16 hp_system", "ring0", out, solutions64[-1].film_solutions["ring0"],
                HP_STREAM_REL_MAX)
    del hp, model64, solutions64, device64, model, solutions, last
    torch.cuda.empty_cache()

    vortices = [st.Vortex(x=x, y=y, film="strip") for x, y in TRANSPORT_VORTICES]
    model = st.factorize_model(
        device=transport, current_units="uA", vortices=vortices,
        terminal_currents={"strip": {"source": 4.0, "drain": -4.0}},
        circulating_currents={"strip_hole": 1.0, "ring_hole": 2.0}, torch_device=CARD,
    )
    solutions = st.solve(
        model=model, applied_field=st.sources.ConstantField(0.1),
        iterations=TRANSPORT_ITERATIONS, torch_device=CARD,
    )
    out, launches, _ = _solve_film_call(
        torch, st, cuda_kernels, "phase16 terminal", transport, model, solutions[-1], "strip",
    )
    count(launches)
    _require(launches["biot_savart_batch"] >= 1, launches)
    _check_film("phase16 terminal", "strip", out, solutions[-1].film_solutions["strip"],
                SOLVE_FILM_REL_MAX)
    del model, solutions
    torch.cuda.empty_cache()

    model, solutions, _ = _factorize_and_solve(torch, st, cuda_kernels, large, "phase16 low-memory")
    _require(not model.film_info["ring0"].dense_kernel, "ring0 is not on the low-memory path")
    out, launches, _ = _solve_film_call(
        torch, st, cuda_kernels, "phase16 low-memory", large, model, solutions[-1], "ring0",
    )
    count(launches)
    _require(launches["q_apply"] >= 1, launches)
    _check_film("phase16 low-memory", "ring0", out, solutions[-1].film_solutions["ring0"],
                SOLVE_FILM_REL_MAX)
    del model, solutions
    torch.cuda.empty_cache()
    print(f"phase16 solve_film launches, all calls: {totals}")

    # 6. Post-processing on the core's ring test (phase 9's times).
    print(
        "phase16 post-processing of phase 4's stack: hole fluxoid {fluxoid:.3f} s with the "
        "geometry core, {fluxoid_plain:.3f} s on the plain route; mutual_inductance_matrix "
        "float32 {mutual:.3f} s with the core, {mutual_plain:.3f} s on the plain route".format(
            **post_times
        )
    )
    return totals



# Phase 17, the multi-device layer.  Sharded against unsharded float32
# results: the same sums split into other shapes (trsm at B / 2 columns,
# the pairwise kernels' source splits at half the rows), so they differ in
# the last bits; 1e-5 of max|g| is the sweep's stream bar class (phase 6's
# pair kernel).  The sharded coupling launches the unsharded kernel's
# arithmetic on each block (1e-6).  The sharded self-field sums B / 2
# columns per block and its row sums q @ w in a launch of their own, where
# Q_apply sums B + 1 columns with the row sums among them, so the float32
# sums of ~27,000 terms run in other orders and the self-field, a small
# difference of two such sums, moves by 3.3e-5 of its max between the two
# (an NVIDIA H100 80GB HBM3 at 700 W).  Both are held to a float64
# evaluation instead, relative to max|self-field|: there they read 7.1e-5
# sharded and 8.7e-5 unsharded on that card, so each must stay within
# 2e-4, and the sharded one within twice the unsharded one's distance (a
# block in the wrong place moves it by O(1)).
PARALLEL_STREAM_REL_MAX = 1e-5
SHARDED_KERNEL_REL_MAX = 1e-6
SELF_FIELD_F64_MAX = 2e-4
SHARDED_OVER_UNSHARDED_MAX = 2.0
# (-A)(M h) = h before refinement: a float32 explicit inverse of a system
# of condition ~1e3-1e4 (ROADMAP), after its one Schulz correction.
INVERSE_RESIDUAL_MAX = 1e-3
SHARDED_SCAN_MAX = 1e-5


def _mesh_devices(torch, k):
    """``k`` mesh slots: the cards in turn where there are several, else
    ``cuda:0`` repeated."""
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(k)]


@contextlib.contextmanager
def _slot_tensors(rows):
    """Records the bytes of every tensor that reaches a model slot
    (``rows._send``) and of every operand and result of a panel product
    with the symmetrised system (``rows._sym_panel``) inside the block:
    the list it yields."""
    seen = []
    send, panel = rows._send, rows._sym_panel

    def recorded_send(t, device):
        seen.append(t.numel() * t.element_size())
        return send(t, device)

    def recorded_panel(A, inv_w, sign, parts):
        out = panel(A, inv_w, sign, parts)
        seen.extend(t.numel() * t.element_size() for t in (*parts, *out))
        return out

    rows._send, rows._sym_panel = recorded_send, recorded_panel
    try:
        yield seen
    finally:
        rows._send, rows._sym_panel = send, panel


def phase_parallel(torch, st, kernels, cuda_kernels, dense_device, large_device, sweep_ref,
                   lu_solutions, scan):
    """Phase 17: ``superscreen_tpu_torch.parallel`` on the card, on a mesh
    of distinct cards where there are several, else of ``cuda:0``
    repeated (every split, per-shard launch, gather and row-sharded
    product runs; only copies between cards do not)."""
    from superscreen_tpu_torch import parallel
    from superscreen_tpu_torch.ops import linalg
    from superscreen_tpu_torch.ops import rows
    from superscreen_tpu_torch.solver.utils import field_conversion_factor
    from superscreen_tpu_torch.squids import scanning
    from superscreen_tpu_torch.sweep import _run_sweep, vortex_flux_quantum

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    print(
        "phase17 mesh slots: "
        + (f"{count} distinct cards in turn" if count > 1 else
           "cuda:0 repeated (one card: the copies between cards do not run)")
    )
    drive = dict(current_units="uA", circulating_currents={"hole0": "1 mA"}, torch_device=CARD)
    films = list(large_device.films)

    # 1. solve_many over two data rows on phase 7's sweep.
    model = st.factorize_model(device=large_device, **drive)
    kwargs = dict(model=model, applied_fields=[st.sources.ConstantField(v) for v in SWEEP_FIELDS],
                  iterations=ITERATIONS)
    sharding = parallel.batch_sharding(parallel.make_mesh(n_data=2, devices=_mesh_devices(torch, 2)))
    _reset_launches(cuda_kernels)
    _sweep(torch, st, **kwargs)
    plain_launches = dict(cuda_kernels.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(cuda_kernels)
    sharded, _ = _sweep(torch, st, sharding=sharding, **kwargs)
    launches = dict(cuda_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err = max(
        float(np.abs(sharded.streams[n] - sweep_ref["streams"][n]).max()
              / np.abs(sweep_ref["streams"][n]).max())
        for n in films
    )
    times = {"sharded": [], "unsharded": []}
    for mode in ("sharded", "unsharded", "unsharded", "sharded"):
        extra = dict(sharding=sharding) if mode == "sharded" else {}
        times[mode].append(_sweep(torch, st, **kwargs, **extra)[1])
    print(
        f"phase17 solve_many(sharding=2 data rows), B={len(SWEEP_FIELDS)}, {ITERATIONS} rounds: "
        f"streams against phase 7's {err:.3e} of max|g| (limit {PARALLEL_STREAM_REL_MAX:.0e}); "
        f"launches {launches} (unsharded {plain_launches}); peak {peak_gb:.3f} GB; wall in turns "
        f"sharded {[round(t, 4) for t in times['sharded']]} s, unsharded "
        f"{[round(t, 4) for t in times['unsharded']]} s"
    )
    _require(err <= PARALLEL_STREAM_REL_MAX, f"sharded sweep {err:.3e}")
    _require(all(launches[k] == 2 * plain_launches[k] for k in launches), (launches, plain_launches))
    _check_sweep_residuals(torch, model, sharded, "phase17 sharded sweep")

    # 2. sharded_film_data on a 2 x 2 mesh of phase 2's dense stack.
    mesh22 = parallel.make_mesh(n_data=2, n_model=2, devices=_mesh_devices(torch, 4))
    dense = st.factorize_model(device=dense_device, **drive)
    data = dense.film_data
    B = len(SWEEP_FIELDS)
    conv = field_conversion_factor("mT", "uA", length_units=dense_device.length_units,
                                   ureg=dense_device.ureg).magnitude
    Hz = {n: torch.as_tensor(np.outer(SWEEP_FIELDS, np.ones(d.n)) * conv, dtype=torch.float32,
                             device=CARD) for n, d in data.items()}
    Ic = {n: torch.tensor([[dense.circulating_currents.get(h, 0.0) for h in d.hole_names]] * B,
                          dtype=torch.float32, device=CARD) for n, d in data.items()}
    flux = vortex_flux_quantum(dense_device, "uA")
    ref, ref_s = _wall(torch, lambda: _run_sweep(data, Hz, Ic, flux, ITERATIONS, 2, "exact"))
    placed = parallel.sharded_film_data(data, mesh22)
    Hs, Is = parallel.shard_sweep_inputs(Hz, Ic, mesh22, film_data=placed)
    _reset_launches(cuda_kernels)
    out, out_s = _wall(torch, lambda: _run_sweep(placed, Hs, Is, flux, ITERATIONS, 2, "exact"))
    launches = dict(cuda_kernels.LAUNCHES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in films:
        n_sites, Qw = data[n].n, placed[n].Qw
        err = float((out[0][n][:, :n_sites] - ref[0][n]).abs().max() / ref[0][n].abs().max())
        pads = out[0][n][:, n_sites:]
        routes = [
            cuda_kernels.residual_plan(b.shape[0], b.shape[1], B // 2, sms,
                                       cuda_kernels._rows_aligned(b)).route
            + (" (TMA)" if cuda_kernels._rows_aligned(b) else " (cp.async windows)")
            for b in Qw.blocks
        ]
        print(
            f"phase17 sharded_film_data 2x2 {n}: {n_sites} sites padded to {Qw.shape[0]}, Qw "
            f"blocks of {[b.shape[0] for b in Qw.blocks]} rows, residual_f64 routes {routes}; "
            f"streams against the unsharded _run_sweep {err:.3e} (limit "
            f"{PARALLEL_STREAM_REL_MAX:.0e}); padded sites exactly 0: {bool((pads == 0).all())}"
        )
        _require(err <= PARALLEL_STREAM_REL_MAX, f"sharded film data {n} {err:.3e}")
        _require(bool((pads == 0).all()), f"padded sites of {n}")
    print(f"phase17 sharded _run_sweep launches {launches}; wall {out_s:.4f} s, unsharded {ref_s:.4f} s")
    del placed, Hs, Is, out, ref, dense, data

    # 3. The sharded coupling and self-field at the 27k stack's shapes.
    f32 = dict(dtype=torch.float32, device=CARD)
    m0, m1 = large_device.meshes["ring0"], large_device.meshes["ring1"]
    src, dst = torch.as_tensor(m0.sites, **f32), torch.as_tensor(m1.sites, **f32)
    areas = torch.as_tensor(m0.vertex_areas, **f32)
    J = torch.as_tensor(sweep_ref["current_densities"]["ring0"], **f32)
    plain = kernels.biot_savart_film_to_film_dz2(src, areas, J, dst, 0.25)
    _reset_launches(cuda_kernels)
    split = parallel.sharded_biot_savart(mesh22, src, areas, J, dst, 0.25)
    bs_launches = cuda_kernels.LAUNCHES["biot_savart_batch"]
    err = float((split - plain).abs().max() / plain.abs().max())
    exact = kernels.biot_savart_film_to_film_dz2(src.double(), areas.double(), J.double(),
                                                 dst.double(), 0.25)
    to_f64 = float((split.double() - exact).abs().max() / exact.abs().max())
    ms = _timed(torch, lambda: parallel.sharded_biot_savart(mesh22, src, areas, J, dst, 0.25), 5)
    plain_ms = _timed(torch, lambda: kernels.biot_savart_film_to_film_dz2(src, areas, J, dst, 0.25), 5)
    print(
        f"phase17 sharded_biot_savart 2x2 {src.shape[0]} -> {dst.shape[0]} sites, B={J.shape[0]}: "
        f"against the unsharded kernel {err:.3e} (limit {SHARDED_KERNEL_REL_MAX:.0e}; "
        f"{to_f64:.3e} from a float64 evaluation); launches "
        f"{bs_launches} (blocks 4); {ms:.4f} ms sharded, {plain_ms:.4f} ms unsharded"
    )
    _require(err <= SHARDED_KERNEL_REL_MAX and bs_launches == 4, f"sharded coupling {err:.3e}")
    w = areas
    g = torch.as_tensor(sweep_ref["streams"]["ring0"], **f32)
    off = kernels.q_apply(src, (w[None, :] * g).T).T
    plain = kernels.Q_apply(src, w, (w[None, :] * g).T).T
    _reset_launches(cuda_kernels)
    diag = parallel.self_field_diagonal(mesh22, src, w)
    diag_launches = cuda_kernels.LAUNCHES["q_apply"]
    _reset_launches(cuda_kernels)
    split = parallel.sharded_self_field(mesh22, src, w, g, diag=diag)
    sf_launches = cuda_kernels.LAUNCHES["q_apply"]
    w64, g64 = w.double(), g.double()
    exact = kernels.Q_apply(src.double(), w64, (w64[None, :] * g64).T).T
    scale = float(exact.abs().max())
    sharded_err, plain_err = (float((t.double() - exact).abs().max()) / scale for t in (split, plain))
    between = float((split - plain).abs().max()) / scale
    ms = _timed(torch, lambda: parallel.sharded_self_field(mesh22, src, w, g, diag=diag), 5)
    plain_ms = _timed(torch, lambda: kernels.Q_apply(src, w, (w[None, :] * g).T), 5)
    print(
        f"phase17 sharded_self_field 2x2 {src.shape[0]} sites, B={g.shape[0]}: against a float64 "
        f"evaluation {sharded_err:.3e} of max|self-field| sharded, {plain_err:.3e} unsharded "
        f"(limit {SELF_FIELD_F64_MAX:.0e} each, and sharded within "
        f"{SHARDED_OVER_UNSHARDED_MAX:g}x unsharded); sharded against unsharded {between:.3e} "
        f"({float((split - plain).abs().max() / off.abs().max()):.3e} of max|q (w g)|); "
        f"q_apply launches {sf_launches} (blocks 4) + {diag_launches} for the diagonal (slots 2); "
        f"{ms:.4f} ms sharded, {plain_ms:.4f} ms unsharded (k = B + 1)"
    )
    _require(sharded_err <= SELF_FIELD_F64_MAX and plain_err <= SELF_FIELD_F64_MAX,
             f"self-field from float64: sharded {sharded_err:.3e}, unsharded {plain_err:.3e}")
    _require(sharded_err <= SHARDED_OVER_UNSHARDED_MAX * plain_err,
             f"sharded self-field {sharded_err:.3e} against the unsharded {plain_err:.3e}")
    _require(sf_launches == 4 and diag_launches == 2, (sf_launches, diag_launches))

    # 4. The sharded explicit inverse of one low-memory film.
    mesh12 = parallel.make_mesh(n_data=1, n_model=2, devices=_mesh_devices(torch, 2))
    system = model.film_systems["ring0"]
    A = system.A
    ni = A.shape[0]
    w_col = model.film_info["ring0"].weights[torch.as_tensor(system.indices, device=CARD)]
    neg_A = -A
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _slot_tensors(rows) as held:
        M, inv_s = _wall(torch, lambda: parallel.sharded_spd_inverse(mesh12, neg_A, w_col, "schur"))
    peak = torch.cuda.max_memory_allocated() - base
    del neg_A
    # Every slot is this card: the peak above the inputs is both slots'
    # iterate and next iterate (PEAK_BLOCKS - 1 matrices beside -A) and
    # their panels (each slot's A_j^T V_j, a gathered panel and pieces).
    matrix = ni * ni * 4
    panels = (2 + 6) * ni * min(rows.PANEL, ni // 2 + 1) * 4
    peak_limit = (rows.PEAK_BLOCKS - 1) * matrix + panels
    h = torch.as_tensor(np.random.default_rng(17).standard_normal((ni, 1)), **f32)
    x = M @ h
    rel = float(torch.linalg.vector_norm(linalg.system_residual(A, h.double(), x))
                / torch.linalg.vector_norm(h.double()))
    x2 = linalg.refine_safeguarded(lambda rhs: M @ rhs, A, h, x, 2)
    rel2 = float(torch.linalg.vector_norm(linalg.system_residual(A, h.double(), x2))
                 / torch.linalg.vector_norm(h.double()))
    print(
        f"phase17 sharded_spd_inverse('schur') of ring0 (ni={ni}) over 2 slots: {inv_s:.3f} s; "
        f"relative residual of (-A)(M h) = h {rel:.3e} (limit {INVERSE_RESIDUAL_MAX:.0e}), "
        f"{rel2:.3e} after 2 refinement steps; largest tensor a slot held {max(held) / 1e6:.1f} MB "
        f"(a slot's rows: {M.blocks[0].numel() * 4 / 1e6:.1f} MB; the whole matrix "
        f"{matrix / 1e6:.1f} MB); peak above the inputs {peak / 1e9:.3f} GB = "
        f"{peak / matrix:.3f} matrices (limit {peak_limit / matrix:.3f}: "
        f"{rows.PEAK_BLOCKS - 1} and the panels)"
    )
    _require(rel <= INVERSE_RESIDUAL_MAX, f"sharded inverse residual {rel:.3e}")
    _require(max(held) <= M.blocks[0].numel() * 4, "a slot held more than its rows")
    _require(peak <= peak_limit, f"sharded inverse peak {peak / matrix:.3f} matrices")
    del M, x, x2

    # The rectangular q_matrix entry at the slot shapes the mesh gives
    # ring0's interior, against its plain version on the same tensors.
    sub = torch.as_tensor(model.film_info["ring0"].sites, **f32)[
        torch.as_tensor(system.indices, device=CARD)
    ].contiguous()
    for r0, r1 in rows.row_bounds(ni, 2):
        _reset_launches(cuda_kernels)
        block = cuda_kernels.q_matrix_rect(sub[r0:r1], sub)
        rect_launches = cuda_kernels.LAUNCHES["q_matrix"]
        abs_err, rel_err = _check_against_plain(
            torch, f"q_matrix_rect rows {r0}:{r1}", torch.float32, block,
            kernels.q_matrix_rect_plain(sub[r0:r1], sub),
        )
        diagonal_zero = bool((block[:, r0:r1].diagonal() == 0).all())
        print(
            f"phase17 q_matrix_rect rows {r0}:{r1} x {ni} of ring0's interior: against "
            f"q_matrix_rect_plain {abs_err:.3e} ({rel_err:.3e} of max, limit "
            f"{TOL['float32']:.0e}); diagonal at column r0 + i zero: {diagonal_zero}; "
            f"launches {rect_launches}"
        )
        _require(diagonal_zero and rect_launches == 1, f"q_matrix_rect rows {r0}:{r1}")
        del block

    # 5. Dense dispatch past the single-device ceiling (the low-memory
    # branch, where the JAX package's ceiling applies).
    nis = {n: len(model.film_systems[n].indices) for n in films}
    ceiling = int(0.8 * min(nis.values()))
    with _environ(SUPERSCREEN_TPU_MAX_MATERIALIZED_N=str(ceiling)):
        parallel.set_factorization_mesh(mesh12)
        try:
            _reset_launches(cuda_kernels)
            inv_model, factor_s = _wall(torch, lambda: st.factorize_model(device=large_device, **drive))
            factor_launches = dict(cuda_kernels.LAUNCHES)
        finally:
            parallel.set_factorization_mesh(None)
    for n in films:
        sys_n = inv_model.film_systems[n]
        _require(sys_n.lu_piv[0] == "inv" and inv_model.film_data[n].fac_kind == "inv", n)
        _require(isinstance(sys_n.A, rows.RowSharded) and len(sys_n.A.blocks) == 2, n)
        _require(isinstance(sys_n.lu_piv[1], rows.RowSharded) and len(sys_n.lu_piv[1].blocks) == 2, n)
    _require(factor_launches["q_matrix"] == 2 * len(films), factor_launches)
    solutions, solve_s = _solve(torch, st, inv_model)
    err = _stream_error(solutions, lu_solutions)
    print(
        f"phase17 factorization mesh 1x2, SUPERSCREEN_TPU_MAX_MATERIALIZED_N={ceiling} (0.8 x the "
        f"smallest ni of {nis}): every film 'inv', A and M in 2 row blocks; factorize "
        f"{factor_s:.3f} s, launches {factor_launches}; solve() {solve_s:.3f} s, streams against "
        f"phase 4's LU solve {err:.3e} of max|g| (limit {STREAM_REL_MAX:.0e})"
    )
    _require(err <= STREAM_REL_MAX, f"inv solve {err:.3e}")
    _check_residuals(torch, inv_model, solutions[-1], "phase17 inv")
    del inv_model, solutions, model

    # 6. Config 5 over two data rows against phase 13's scan.
    M_scan, scan_s = _wall(torch, lambda: scanning.susceptibility_scan(
        scan["sample"], squid_solution=scan["squid_solution"], positions=scan["positions"],
        squid_height=1.0, pickup_loop="pl", I_fc="1 mA", sharding=sharding, torch_device=CARD))
    err = float(np.abs(M_scan - scan["M"]).max() / np.abs(scan["M"]).max())
    print(
        f"phase17 config-5 scan over 2 data rows (B={len(scan['M'])}): {scan_s:.3f} s with its "
        f"factorization; against phase 13's {err:.3e} (limit {SHARDED_SCAN_MAX:.0e})"
    )
    _require(err <= SHARDED_SCAN_MAX, f"sharded scan {err:.3e}")
    print(f"phase17 wall time {time.perf_counter() - t_phase:.1f} s")


# Phase 18: the large-film factorization routes in turns, LU first (the
# reference).  solve() refines every round on every route, so the routes'
# streams differ from LU's by the refinement's float32 floor.
ROUTES = ("lu", "inv", "chol", "schur", "schulz")
ROUTE_STREAM_REL_MAX = 1e-6


@contextlib.contextmanager
def _route(name):
    """Inside the block the films on the card above LU_MAX_N_TPU take
    ``name``: a value of SUPERSCREEN_TPU_LARGE_FACTOR, or ``"lu"``
    (LU_MAX_N_TPU raised past any film)."""
    from superscreen_tpu_torch.ops import linalg

    if name != "lu":
        with _environ(SUPERSCREEN_TPU_LARGE_FACTOR=name):
            yield
        return
    previous = linalg.LU_MAX_N_TPU
    linalg.LU_MAX_N_TPU = 2**62
    try:
        yield
    finally:
        linalg.LU_MAX_N_TPU = previous


@contextlib.contextmanager
def _factor_peaks(torch, peaks):
    """Inside the block every ``ops.linalg.factor_system`` call appends the
    most device bytes it held at once, its system ``A`` included, in
    ``(ni, ni)`` matrices of ``A``'s dtype."""
    from superscreen_tpu_torch.ops import linalg

    factor = linalg.factor_system

    def recorded(A, *args, **kwargs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = factor(A, *args, **kwargs)
        torch.cuda.synchronize()
        matrix = A.numel() * A.element_size()
        peaks.append((torch.cuda.max_memory_allocated() - base + matrix) / matrix)
        return out

    linalg.factor_system = recorded
    try:
        yield
    finally:
        linalg.factor_system = factor


def _run_route(torch, st, device, route, label, profile):
    """One route on one stack: factorize (wall, peak buffers), warm solve(),
    the B = 8 sweep (residuals, warm time) and the same sweep with refined
    inner rounds.  Returns the last round's solution, the sweep and the
    numbers of the table row."""
    from superscreen_tpu_torch.solver.solve_film import INVERSE_PEAK_BUFFERS, LU_PEAK_BUFFERS

    fields = [st.sources.ConstantField(v) for v in SWEEP_FIELDS]
    torch.cuda.empty_cache()
    peaks = []
    with _route(route), _factor_peaks(torch, peaks):
        model, factor_s = _wall(torch, lambda: st.factorize_model(
            device=device, current_units="uA", circulating_currents={"hole0": "1 mA"},
            torch_device=CARD))
    kinds = {data.fac_kind for data in model.film_data.values()}
    _require(kinds == {"lu" if route == "lu" else ("chol" if route == "chol" else "inv")},
             f"{label} {route}: {kinds}")
    # The budget each route's materialized ceiling is sized for (LU's
    # workspace takes it a hair past its three buffers: printed only).
    budget = INVERSE_PEAK_BUFFERS if route in ("schur", "schulz") else LU_PEAK_BUFFERS
    _require(route == "lu" or max(peaks) <= budget, f"{route} peak {max(peaks):.3f} matrices")
    solutions = _solve(torch, st, model)[0]
    solve_s = min(_solve(torch, st, model)[1] for _ in range(3))
    _check_residuals(torch, model, solutions[-1], f"phase18 {label} {route} solve()")
    kwargs = dict(model=model, applied_fields=fields, iterations=ITERATIONS)
    sweep = _sweep(torch, st, **kwargs)[0]
    sweep_s = min(_sweep(torch, st, **kwargs)[1] for _ in range(2))
    _check_sweep_residuals(torch, model, sweep, f"phase18 {label} {route} sweep")
    with _environ(SUPERSCREEN_TPU_INNER_REFINE="2"):
        refined = _sweep(torch, st, **kwargs)[0]
    if profile:
        watch = ("trsm", "trsv", "gemv", "gemm")
        _profile(torch, lambda: _solve(torch, st, model)[1],
                 f"phase18 {label} profile of the warm solve ({route})", watch=watch)
        _profile(torch, lambda: _sweep(torch, st, **kwargs)[1],
                 f"phase18 {label} profile of the warm sweep ({route})", watch=watch)
    row = dict(factor_s=factor_s, peak=max(peaks), budget=budget, solve_ms=solve_s * 1e3,
               point_ms=sweep_s / len(fields) * 1e3, inner=_sweep_stream_error(sweep, refined))
    del model
    return solutions, sweep, row


def phase_routes(torch, st, stacks):
    """The routes in turns on each ``(label, device)`` of ``stacks``: every
    route's solve() streams within ROUTE_STREAM_REL_MAX of LU's, residuals
    at most RESIDUAL_MAX, and one table row per route."""
    t_phase = time.perf_counter()
    for label, device in stacks:
        reference = None
        for route in ROUTES:
            solutions, sweep, row = _run_route(torch, st, device, route, label, route == "inv")
            if reference is None:
                reference = (solutions, sweep)
            err = _stream_error(solutions, reference[0])
            err_sweep = _sweep_stream_error(sweep, reference[1])
            print(
                f"phase18 {label} {route:6s}: factorize {row['factor_s']:.3f} s, peak "
                f"{row['peak']:.3f} (ni, ni) buffers (budget {row['budget']}); warm solve() {row['solve_ms']:.2f} ms; "
                f"sweep B={len(SWEEP_FIELDS)} {row['point_ms']:.2f} ms per point; solve() "
                f"streams against LU's {err:.3e} (limit {ROUTE_STREAM_REL_MAX:.0e}); sweep "
                f"against LU's sweep {err_sweep:.3e}; default sweep against "
                f"SUPERSCREEN_TPU_INNER_REFINE=2 {row['inner']:.3e}"
            )
            _require(err <= ROUTE_STREAM_REL_MAX, f"{label} {route} against LU {err:.3e}")
            del solutions, sweep
    print(f"phase18 wall time {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import superscreen_tpu_torch as st
    from superscreen_tpu_torch import native
    from superscreen_tpu_torch.ops import cuda_kernels, kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    start = t0 = time.perf_counter()
    cuda_kernels.load_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_library()
    native_s = time.perf_counter() - t0
    print(
        f"torch {torch.__version__} CUDA {torch.version.cuda} numpy {np.__version__}; "
        f"kernel build {build_s:.2f} s; geometry core ({native.compiler()}) {native_s:.2f} s"
    )
    t0 = time.perf_counter()
    device = four_ring_stack(st, SITES_DENSE)
    large = four_ring_stack(st, SITES_LARGE)
    print(f"mesh of the two four-ring stacks: {time.perf_counter() - t0:.3f} s")
    rows = phase_kernels(torch, kernels, cuda_kernels, device)
    rows.update(phase_lowmem_kernels(torch, kernels, cuda_kernels, large))
    rows.update(phase_residual_kernel(torch, kernels, cuda_kernels))
    with _exact_coupling():
        launches, stack_streams, stack_solution = phase_solve(torch, st, cuda_kernels, device)
        phase_accuracy(st)
        model, lu_solutions, lowmem_launches = phase_lowmem(torch, st, cuda_kernels, large)
        pair_launches = phase_pair(torch, st, cuda_kernels, model, lu_solutions)
        sweep_launches, exact_sweep = phase_sweep(torch, st, cuda_kernels, model, lu_solutions)
        map_launches, post_times = phase_postprocess(
            torch, st, kernels, cuda_kernels, model, lu_solutions
        )
        certify_launches = phase_certify(torch, st, cuda_kernels, model, large)
    fft_launches, auto_wrong = phase_fft(torch, st, cuda_kernels, model, exact_sweep)
    sweep_ref = dict(streams=exact_sweep.streams, current_densities=exact_sweep.current_densities)
    del model, exact_sweep
    with _exact_coupling():
        phase_cg(torch, st, cuda_kernels, large, lu_solutions)
        transport_launches, transport = phase_transport(torch, st, kernels, cuda_kernels)
        phase_huber(torch, st, cuda_kernels)
    scan_launches, scan_context = phase_scanning(torch, st, kernels, cuda_kernels)
    adjoint_fwd, adjoint_bwd = phase_adjoint(
        torch, st, kernels, cuda_kernels, device, stack_streams, scan_context
    )
    scan_ref = dict(scan_context, squid_solution=scan_context["squid_solution"]["float32"])
    del scan_context
    with _exact_coupling():
        transform_launches = phase_transforms(
            torch, st, kernels, cuda_kernels, device, stack_solution
        )
    with _exact_coupling():
        solve_film_launches = phase_native_solve_film(
            torch, st, cuda_kernels, device, large, transport, post_times
        )
    with _exact_coupling():
        phase_parallel(
            torch, st, kernels, cuda_kernels, device, large, sweep_ref, lu_solutions, scan_ref
        )
    del stack_solution, transport, scan_ref, sweep_ref, lu_solutions
    with _exact_coupling():
        phase_routes(torch, st, [("dense 20k stack", device), ("low-memory 27k stack", large)])
    del device, large
    # The sweep paths must have gone through their kernels too.
    _require(
        all(sweep_launches[k] > 0 for k in ("biot_savart_batch", "q_apply")), sweep_launches
    )
    _require(
        all(transport_launches[k] > 0 for k in ("biot_savart_batch", "q_apply")),
        transport_launches,
    )
    _require(map_launches["biot_savart_batch"] > 0, map_launches)
    _require(scan_launches["biot_savart_batch"] > 0, scan_launches)
    _require(adjoint_fwd["biot_savart_batch"] > 0 and adjoint_bwd["biot_savart_batch"] > 0,
             (adjoint_fwd, adjoint_bwd))
    _require(fft_launches["q_apply"] > 0 and fft_launches["residual_f64"] > 0, fft_launches)
    _require(
        all(transform_launches[k] > 0 for k in ("q_matrix", "biot_savart_batch", "residual_f64")),
        transform_launches,
    )
    _require(
        all(solve_film_launches[k] > 0 for k in ("biot_savart_batch", "q_apply", "residual_f64")),
        solve_film_launches,
    )
    _require(not auto_wrong, f"coupling='auto' against the measured faster mode: {auto_wrong}")
    _require(
        all(d["residual_f64"] > 0 for d in (sweep_launches, transport_launches, certify_launches)),
        (sweep_launches, transport_launches, certify_launches),
    )
    # Each kernel's launches on the path it serves: the dense solve (phase
    # 2), the low-memory solve (phase 4) and the pair-coupling solve
    # (phase 6).
    # residual_f64 on the low-memory solve (phase 4), whose systems have
    # the size it is timed at.
    launches.update(
        q_apply=lowmem_launches["q_apply"], biot_savart_pair=pair_launches["biot_savart_pair"],
        residual_f64=lowmem_launches["residual_f64"],
    )
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
        # No Pallas kernel: the JAX package forms this residual in plain XLA.
        "residual_f64": (
            "superscreen_tpu_torch/csrc/residual_f64.cu", "superscreen_tpu/certify.py:104",
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
    print(f"chip_smoke wall time: {time.perf_counter() - start:.1f} s")
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

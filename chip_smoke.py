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

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

import json
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
        print(
            f"phase1 q_matrix n={n} {name}: max_abs_err={abs_err:.3e} "
            f"rel_err={rel:.3e} (limit {TOL[name]:.0e}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f}"
        )
        _require(rel <= TOL[name], f"q_matrix {name} disagrees: {rel:.3e}")
        if dtype == torch.float32:
            rows["q_matrix"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
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
                print(
                    f"phase1 biot_savart_batch n1={n1} n2={n2} B={B} dz2={dz2} {name}: "
                    f"max_abs_err={abs_err:.3e} rel_err={rel:.3e} (limit {TOL[name]:.0e}) "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
                )
                _require(rel <= TOL[name], f"biot_savart_batch {name} disagrees: {rel:.3e}")
                if dtype == torch.float32 and B == 1:
                    row = rows.setdefault(
                        "biot_savart_batch", dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
                    )
                    row["max_abs_err"] = max(row["max_abs_err"], abs_err)
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


def phase_solve(torch, st, cuda_kernels, device):
    """The dense multi-film solve at real size on the meshed ``device``;
    returns the launch counts."""
    from superscreen_tpu_torch.solver.utils import (
        MAX_DENSE_KERNEL_SIZE,
        field_conversion_factor,
    )
    from superscreen_tpu_torch.sweep import relative_residual

    iterations = 5
    sizes = {name: len(mesh.sites) for name, mesh in device.meshes.items()}
    print(f"phase2 mesh sites per film: {sizes}")
    _require(all(n <= MAX_DENSE_KERNEL_SIZE for n in sizes.values()), sizes)
    torch.cuda.reset_peak_memory_stats()
    for key in cuda_kernels.LAUNCHES:
        cuda_kernels.LAUNCHES[key] = 0
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
    t0 = time.perf_counter()
    solutions = st.solve(
        model=model,
        applied_field=st.sources.ConstantField(1.0),
        iterations=iterations,
        torch_device="cuda",
    )
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(
        f"phase2 times: factorize_s={t_factor:.3f} "
        f"solve_s={t_solve:.3f} (iterations={iterations}) peak_memory_GB={peak_gb:.3f}"
    )
    print(f"phase2 launches: {launches}")
    _require(len(solutions) == iterations + 1)
    _require(set(model.film_data) == set(device.films))
    for name in device.films:
        data = model.film_data[name]
        _require(data.Qw.shape == (sizes[name], sizes[name]), "film not on the dense path")
        for sol in solutions:
            fs = sol.film_solutions[name]
            outputs = [fs.stream, fs.current_density, fs.self_field, fs.applied_field]
            if fs.field_from_other_films is not None:
                outputs.append(fs.field_from_other_films)
            for arr in outputs:
                _require(np.all(np.isfinite(arr)), f"non-finite output in {name}")
    _require(launches["q_matrix"] >= len(device.films), launches)
    _require(launches["biot_savart_batch"] >= 12 * iterations, launches)
    conv = field_conversion_factor(
        "mT", "uA", length_units=device.length_units, ureg=device.ureg
    ).magnitude
    final = solutions[-1]
    for name in device.films:
        fs = final.film_solutions[name]
        data = model.film_data[name]
        Hz = (fs.applied_field + fs.field_from_other_films) * conv
        I_circ = [[model.circulating_currents.get(h, 0.0) for h in data.hole_names]]
        res = float(
            relative_residual(
                data,
                torch.as_tensor(Hz[None], dtype=data.A.dtype, device="cuda"),
                torch.as_tensor(I_circ, dtype=data.A.dtype, device="cuda"),
                torch.as_tensor(fs.stream[None], dtype=data.A.dtype, device="cuda"),
            )[0]
        )
        print(f"phase2 {name}: final relative residual {res:.3e} (limit {RESIDUAL_MAX:.0e})")
        _require(res <= RESIDUAL_MAX, f"{name} residual {res:.3e}")
    return launches


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
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}; kernel build {build_s:.2f} s")
    t0 = time.perf_counter()
    device = four_ring_stack(st, 20000)
    print(f"mesh of the four-ring stack: {time.perf_counter() - t0:.3f} s")
    rows = phase_kernels(torch, kernels, cuda_kernels, device)
    launches = phase_solve(torch, st, cuda_kernels, device)
    phase_accuracy(st)
    sources = {
        "q_matrix": ("superscreen_tpu_torch/csrc/q_matrix.cu", "superscreen_tpu/ops/pallas_kernels.py:138"),
        "biot_savart_batch": (
            "superscreen_tpu_torch/csrc/biot_savart.cu",
            "superscreen_tpu/ops/pallas_kernels.py:201",
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
        for name in ("q_matrix", "biot_savart_batch")
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

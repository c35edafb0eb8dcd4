#!/usr/bin/env python3
"""Times the biot_savart_pair CUDA kernel of several builds of the port in
turns on one card, beside two biot_savart_batch passes, and reads what the
compiler made of each build.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/kernel_turns.py [--root NAME=DIR ...] [--rounds N] [--sass DIR]

A root is a directory that holds ``superscreen_tpu_torch/ops/cuda_kernels.py``
and ``superscreen_tpu_torch/csrc/``: this checkout (``current``, always
timed) or another commit unpacked beside it, for example
``git archive <commit> superscreen_tpu_torch | tar -x -C <dir>``.  Each
root's kernel library is built into its own ``_build`` directory and
loaded as a module of its own, so the builds never share a kernel.

The shapes are those of ``chip_smoke.py`` phase 1: films 0 and 1 of the
27,298-site four-ring stack, dz2 = 0.25, float32 and float64, B = 1 and 8.
Each build's output is first held against the plain version (the
tolerances of ``chip_smoke.py``).  Then, for each shape, every build and
the two passes are timed by CUDA events (10 launches each time) in the
order A, B, ..., then back (A B C C B A), ``--rounds`` times, and each
entry's mean over its turns is printed beside the kernel's bound.

With ``--sass DIR`` each root's ``biot_savart_pair.cu`` (and this
checkout's ``biot_savart.cu``) is also compiled with ``-Xptxas -v``: the
registers, spills and shared memory of every kernel instantiation are
printed, the SASS is written to DIR, and for every instantiation the
innermost loop that holds the reciprocal square roots (``MUFU.RSQ``) is
found and its instructions per reciprocal square root, that is per pair,
are printed with their opcodes.

With ``--kernel residual`` the kernel in turns is ``residual_f64``
instead (R = H + A X with a float32 A, float64 sums), at every shape of
``chip_smoke.RESIDUAL_SHAPES`` (float64 X and H, which every build takes),
beside the widened blocked route (its plain version) and the float32
``addmm`` that reads the same bytes; then this checkout's two routes in
turns (stream, tensor cores, tensor cores, stream) at ``chip_smoke.
RESIDUAL_N`` unknowns (rows 16-byte aligned) and 2 fewer (rows 8 bytes
off) for each k that the stream route takes there (below
``RESIDUAL_MMA_MIN_K_ALIGNED`` and ``RESIDUAL_MMA_MIN_K``; the plan
replaced by the other route's), and this checkout's kernel with 1 to 16 splits of
the columns of A at 20,274^2 and 16,768^2, the sweep behind the plan's
``_RESIDUAL_SPAN_BYTES``.  ``--sass`` then reads ``residual_f64.cu`` and
``residual_f64_mma.cu`` and counts the loops that hold the float64 FMAs
and the DMMAs.  ``--landscape`` also times phase 13's vortex landscape
(the 15,310-site disk, identity blocks of 2,048 columns refined through
``residual_f64``) once per build in a process of its own, in turns.  To
time this commit against its parent:

    mkdir -p _turns/parent && git archive HEAD~1 superscreen_tpu_torch | tar -x -C _turns/parent
    python3 tools/kernel_turns.py --kernel residual --root parent=_turns/parent --landscape

To time the stream route's TMA copies of aligned rows against its
cp.async windows, add a root whose stream route takes the windows at
every alignment (and so only the windows' widths):

    mkdir -p _turns/windows && git archive HEAD superscreen_tpu_torch | tar -x -C _turns/windows
    sed -i 's/const bool tma = .*;/const bool tma = false;/' \\
        _turns/windows/superscreen_tpu_torch/csrc/residual_f64.cu
    sed -i 's/^RESIDUAL_MMA_MIN_K_ALIGNED = .*/RESIDUAL_MMA_MIN_K_ALIGNED = 6/' \\
        _turns/windows/superscreen_tpu_torch/ops/cuda_kernels.py
    python3 tools/kernel_turns.py --kernel residual --root windows=_turns/windows

To sweep the routes past the stream route's widths, run this script from a
copy whose stream route is built wider (``STREAM_MAX_K`` and
``STREAM_WINDOWS_MAX_K`` in ``residual_f64.cuh``) and taken below higher
``RESIDUAL_MMA_MIN_K`` and ``RESIDUAL_MMA_MIN_K_ALIGNED``:

    mkdir -p _turns/wide && git archive HEAD | tar -x -C _turns/wide
    sed -i 's/MAX_K = .*;/MAX_K = 16;/' _turns/wide/superscreen_tpu_torch/csrc/residual_f64.cuh
    sed -i 's/^\\(RESIDUAL_MMA_MIN_K[_A-Z]*\\) = .*/\\1 = 17/' \\
        _turns/wide/superscreen_tpu_torch/ops/cuda_kernels.py
    (cd _turns/wide && python3 tools/kernel_turns.py --kernel residual)

The last line is a JSON summary.
"""

import argparse
import collections
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def load_kernels(name, root):
    """The ``cuda_kernels`` module of ``root`` as a module of its own, with
    its library built."""
    path = Path(root).resolve() / "superscreen_tpu_torch" / "ops" / "cuda_kernels.py"
    spec = importlib.util.spec_from_file_location(f"kernel_turns_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    t0 = time.perf_counter()
    module.load_library()
    print(f"{name}: {path.parent.parent} built in {time.perf_counter() - t0:.2f} s")
    return module


def ptxas_report(module, source, sass_dir, label, marker="MUFU.RSQ"):
    """Compiles ``source`` with ``-Xptxas -v``; returns per-kernel rows of
    registers, spills, shared memory and the innermost MUFU loop."""
    obj = Path(sass_dir) / f"{label}.o"
    cmd = [module._nvcc(), *module._NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(source)]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    rows, current = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            rows[current] = {}
        elif current and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            rows[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif current and "Used" in line and "registers" in line:
            rows[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rows[current]["smem_bytes"] = int(m.group(1)) if m else 0
    cuobjdump = str(Path(module._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                          check=True).stdout
    (Path(sass_dir) / f"{label}.sass").write_text(sass)
    for fn, body in _sass_functions(sass):
        if fn in rows:
            rows[fn].update(_inner_loop(body, marker))
    obj.unlink()
    return {_readable(fn): row for fn, row in rows.items()}


def _sass_functions(sass):
    name, lines = None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                yield name, lines
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        yield name, lines


def _inner_loop(lines, marker="MUFU.RSQ"):
    """The shortest backward-branch span that holds ``marker`` (a
    reciprocal square root: one per pair): its instructions, the marker's
    count and the opcode counts."""
    instrs, labels = [], {}
    pending = []
    for line in lines:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2).strip()
        for label in pending:
            labels[label] = addr
        pending = []
        instrs.append((addr, text))
    best = None
    for addr, text in instrs:
        m = re.search(r"\bBRA\b\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is None or target > addr:
            continue
        span = [t for a, t in instrs if target <= a <= addr]
        rsq = sum(1 for t in span if marker in t)
        if rsq and (best is None or len(span) < len(best)):
            best = span
    if best is None:
        return {}
    rsq = sum(1 for t in best if marker in t)
    ops = collections.Counter(
        re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for t in best
    )
    return {
        "loop_instructions": len(best),
        "loop_rsqrt": rsq,
        "instructions_per_pair": round(len(best) / rsq, 3),
        "opcodes_per_pair": {op: round(n / rsq, 3) for op, n in ops.most_common()},
    }


def _readable(fn):
    m = re.search(r"([a-z][a-z_0-9]*_kernel)ILi(\d+)E([fd])E", fn)
    if m:
        return f"{m.group(1)}<{m.group(2)}, {'float' if m.group(3) == 'f' else 'double'}>"
    m = re.search(r"([a-z_0-9]+_kernel)I([fd])Li(\d+)E", fn)
    if m:
        return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}, {m.group(3)}>"
    m = re.search(r"([a-z_0-9]+_kernel)ILi(\d+)E", fn)
    return f"{m.group(1)}<{m.group(2)}>" if m else fn


def _in_turns(torch, chip_smoke, fns, rounds, reps):
    """Times each of ``fns`` in the order A B ... then back, ``rounds``
    times; returns each label's list of ms per call."""
    order = list(fns) + list(fns)[::-1]
    times = collections.defaultdict(list)
    for _ in range(rounds):
        for label in order:
            times[label].append(chip_smoke._timed(torch, fns[label], reps))
    return times


def residual_turns(torch, chip_smoke, kernels, builds, rounds, summary):
    """residual_f64 of every build that has it, held against the plain
    version and timed in turns beside the widened route and the float32
    addmm, at chip_smoke.RESIDUAL_SHAPES; then this build's two routes in
    turns for the k that either may take."""
    for m, n, k in chip_smoke.RESIDUAL_SHAPES:
        A, X, H = chip_smoke._residual_inputs(torch, m, n, k, seed=77 + k)
        ref = kernels.residual_f64_plain(A, X, H)
        fns = {}
        for label, module in builds.items():
            if not hasattr(module, "residual_f64"):
                continue
            before = module.LAUNCHES["residual_f64"]
            _, rel = chip_smoke._check_against_plain(
                torch, f"{label} residual_f64 m={m} k={k}", torch.float64,
                module.residual_f64(A, X, H), ref,
            )
            launches = module.LAUNCHES["residual_f64"] - before
            print(f"{label} residual_f64 m={m} n={n} k={k}: rel_err={rel:.3e} launches={launches}")
            fns[label] = (lambda mod: lambda: mod.residual_f64(A, X, H))(module)
        del ref
        wide = k > 100
        if not wide:
            x32, h32 = X.float(), H.float()
            fns["widened_blocks"] = lambda: kernels.residual_f64_plain(A, X, H)
            fns["float32_addmm"] = lambda: torch.addmm(h32, A, x32)
        times = _in_turns(torch, chip_smoke, fns, rounds, 2 if wide else 10)
        bound = chip_smoke._residual_bound(m, n, k)
        for label, ms in times.items():
            mean = sum(ms) / len(ms)
            print(
                f"turns residual_f64 m={m} n={n} k={k} {label}: mean_ms={mean:.4f} "
                f"turns={[round(t, 4) for t in ms]} bound_ms={bound[0]:.4f} ({bound[1]}) "
                f"share_of_bound={bound[0] / mean:.3f}"
            )
            summary["times"].append(dict(kernel="residual_f64", m=m, n=n, k=k, build=label,
                                         mean_ms=mean, turns_ms=ms, bound_ms=bound[0]))
        del A, X, H, fns
        torch.cuda.empty_cache()
    current = builds["current"]

    def on_route(route):
        """This build's residual_f64 with its plan replaced by ``route``'s."""
        def call():
            planned = current.residual_plan
            current.residual_plan = lambda m, n, k, sms=132, aligned=False: current._route_plan(
                m, n, k, sms, route)
            try:
                return current.residual_f64(A, X, H)
            finally:
                current.residual_plan = planned
        return call

    # Rows 16-byte aligned (the stream route's TMA) and 8 bytes off (its
    # windows).
    for n, k in [(n, k) for n, least in ((chip_smoke.RESIDUAL_N, current.RESIDUAL_MMA_MIN_K_ALIGNED),
                                         (chip_smoke.RESIDUAL_N - 2, current.RESIDUAL_MMA_MIN_K))
                 for k in range(1, least)]:
        A, X, H = chip_smoke._residual_inputs(torch, n, n, k, seed=77 + k)
        ref = kernels.residual_f64_plain(A, X, H)
        fns = {}
        for route in ("stream", "mma"):
            fns[route] = on_route(route)
            chip_smoke._check_against_plain(
                torch, f"residual_f64 {route} k={k}", torch.float64, fns[route](), ref,
            )
        times = _in_turns(torch, chip_smoke, fns, rounds, 10)
        bound = chip_smoke._residual_bound(n, n, k)
        means = {route: sum(ms) / len(ms) for route, ms in times.items()}
        print(
            f"route sweep residual_f64 n={n} k={k}: "
            + " ".join(f"{r}_ms={t:.4f} ({bound[0] / t:.3f} of bound)" for r, t in means.items())
            + f" faster={min(means, key=means.get)} "
            + f"plan={current.residual_plan(n, n, k, 132, current._rows_aligned(A)).route}"
        )
        summary["route_sweep"].append(dict(n=n, k=k, bound_ms=bound[0],
                                           **{f"{r}_ms": t for r, t in means.items()}))
        del A, X, H, ref
        torch.cuda.empty_cache()


def split_sweep(torch, chip_smoke, kernels, current, summary):
    """This build's residual_f64 with its plan's split of the columns of A
    replaced by 1, 2, 4, 8 and 16 splits (grid and split lengths as the
    plan would cut them), at the shapes where the rows in flight decide
    the time: the sweep behind ``_RESIDUAL_SPAN_BYTES``."""
    import dataclasses

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = current.residual_plan
    for m, k in ((20274, 1), (20274, 6), (chip_smoke.RESIDUAL_N, 1), (chip_smoke.RESIDUAL_N, 8)):
        A, X, H = chip_smoke._residual_inputs(torch, m, m, k, seed=5)
        ref = kernels.residual_f64_plain(A, X, H)
        plan = planned(m, m, k, sms, current._rows_aligned(A))
        bound = chip_smoke._residual_bound(m, m, k)
        for splits in (1, 2, 4, 8, 16):
            length = -(-plan.tiles // splits)
            slots = sms * current._RESIDUAL_BLOCKS_PER_SM
            forced = dataclasses.replace(
                plan, splits=splits, split_tiles=length,
                grid=min(plan.row_blocks * plan.col_blocks * splits, slots),
            )
            current.residual_plan = lambda *args, **kwargs: forced
            try:
                chip_smoke._check_against_plain(
                    torch, f"residual_f64 m={m} k={k} splits={splits}", torch.float64,
                    current.residual_f64(A, X, H), ref,
                )
                ms = chip_smoke._timed(torch, lambda: current.residual_f64(A, X, H), 20)
            finally:
                current.residual_plan = planned
            rows = min(m, -(-forced.grid // (splits * plan.col_blocks)) * plan.rows)
            print(
                f"split sweep residual_f64 m=n={m} k={k} {plan.route} splits={splits} "
                f"(plan {plan.splits}): {ms:.4f} ms, share_of_bound={bound[0] / ms:.3f}, rows in "
                f"flight {rows} ({rows * m * 4 / 1e6:.0f} MB of A)"
            )
            summary["split_sweep"].append(dict(m=m, k=k, route=plan.route, splits=splits,
                                               plan_splits=plan.splits, ms=ms, rows_in_flight=rows))
        del A, X, H, ref
        torch.cuda.empty_cache()


def landscape_child(root):
    """Phase 13's vortex landscape with the package under ``root``: prints
    one JSON line with its wall time (kernels built first) and launches."""
    sys.path.insert(0, str(Path(root).resolve()))
    sys.path.insert(1, str(REPO))
    import chip_smoke
    import torch
    import superscreen_tpu_torch as st
    from superscreen_tpu_torch.ops import cuda_kernels

    cuda_kernels.load_library()
    disk = st.Device(
        "disk", layers=[st.Layer("L", Lambda=0.5, z0=0)],
        films=[st.Polygon("disk", layer="L", points=st.geometry.circle(4.0, points=160))],
        length_units="um",
    )
    disk.make_mesh(min_points=chip_smoke.LANDSCAPE_POINTS, smooth=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.vortex_energy_landscape(disk, applied_field=st.sources.ConstantField(0.1),
                               field_units="mT", current_units="mA", torch_device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps(dict(package=st.__file__, sites=len(disk.meshes["disk"].sites),
                          wall_s=wall, launches=dict(cuda_kernels.LAUNCHES))))


def landscape_turns(roots, rounds, summary):
    """Phase 13's landscape once per root and turn (A B ... then back), each
    in a process of its own."""
    order = roots + roots[::-1]
    for _ in range(rounds):
        for name, root in order:
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--landscape-child", root],
                capture_output=True, text=True, cwd=str(REPO),
            )
            if out.returncode != 0:
                raise RuntimeError(f"landscape with {name} failed:\n{out.stdout}\n{out.stderr}")
            result = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"turns landscape {name}: wall_s={result['wall_s']:.4f} sites={result['sites']} "
                  f"launches={result['launches']} ({result['package']})")
            summary["landscape"].append(dict(build=name, **result))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", default=[], metavar="NAME=DIR",
                        help="another build to time beside this checkout")
    parser.add_argument("--rounds", type=int, default=1, help="A..Z Z..A passes per shape")
    parser.add_argument("--sass", metavar="DIR", help="write SASS and print ptxas counts")
    parser.add_argument("--kernel", choices=("pair", "residual"), default="pair",
                        help="the kernel to time in turns (default: biot_savart_pair)")
    parser.add_argument("--landscape", action="store_true",
                        help="with --kernel residual: phase 13's landscape per build, in turns")
    parser.add_argument("--landscape-child", metavar="ROOT", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.landscape_child:
        landscape_child(args.landscape_child)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import superscreen_tpu_torch as st
    from superscreen_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    roots = [("current", str(REPO))] + [tuple(r.split("=", 1)) for r in args.root]
    builds = {}
    for name, root in roots:
        try:
            builds[name] = load_kernels(name, root)
        except RuntimeError as err:  # another build that does not compile is reported
            if name == "current":
                raise
            print(f"{name}: BUILD FAILED: {err}")
    roots = [(name, root) for name, root in roots if name in builds]
    summary = {"device": smi, "ptxas": {}, "times": [], "route_sweep": [], "split_sweep": [],
               "landscape": []}
    if args.sass and args.kernel == "residual":
        os.makedirs(args.sass, exist_ok=True)
        for name, root in roots:
            for stem, marker in (("residual_f64", "DFMA"), ("residual_f64_mma", "DMMA")):
                source = Path(root) / f"superscreen_tpu_torch/csrc/{stem}.cu"
                if source.exists():
                    report = ptxas_report(builds[name], source, args.sass, f"{name}_{stem}", marker)
                    summary["ptxas"][f"{name}_{stem}"] = report
                    for fn, row in report.items():
                        print(f"ptxas {name} {fn}: {json.dumps(row)}")
    elif args.sass:
        os.makedirs(args.sass, exist_ok=True)
        sources = [(name, Path(root) / "superscreen_tpu_torch/csrc/biot_savart_pair.cu")
                   for name, root in roots]
        sources.append(("current_batch", REPO / "superscreen_tpu_torch/csrc/biot_savart.cu"))
        for label, source in sources:
            module = builds[label.replace("_batch", "")]
            report = ptxas_report(module, source, args.sass, label)
            summary["ptxas"][label] = report
            for fn, row in report.items():
                print(f"ptxas {label} {fn}: {json.dumps(row)}")

    if args.kernel == "residual":
        residual_turns(torch, chip_smoke, kernels, builds, args.rounds, summary)
        split_sweep(torch, chip_smoke, kernels, builds["current"], summary)
        if args.landscape:
            landscape_turns(roots, args.rounds, summary)
        print(json.dumps(summary))
        return 0
    device = chip_smoke.four_ring_stack(st, chip_smoke.SITES_LARGE)
    meshes = list(device.meshes.values())
    n1, n2 = len(meshes[0].sites), len(meshes[1].sites)
    rng = np.random.default_rng(4321)
    current = builds["current"]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device="cuda")

        s1, s2 = t(meshes[0].sites), t(meshes[1].sites)
        a1, a2 = t(meshes[0].vertex_areas), t(meshes[1].vertex_areas)
        for B in (1, 8):
            J1, J2 = t(rng.standard_normal((B, n1, 2))), t(rng.standard_normal((B, n2, 2)))
            pair_args = (s1, a1, J1, s2, a2, J2, 0.25)
            ref = kernels.biot_savart_pair_plain(*pair_args)
            fns = {}
            for label, module in builds.items():
                out = module.biot_savart_pair(*pair_args)
                try:
                    _, rel = chip_smoke._check_against_plain(
                        torch, f"{label} biot_savart_pair B={B} {name}", dtype, out, ref
                    )
                except RuntimeError as err:  # a wrong build is reported, not timed
                    print(f"{label} biot_savart_pair B={B} {name}: WRONG: {err}")
                    summary["wrong"] = summary.get("wrong", []) + [f"{label} B={B} {name}"]
                    continue
                print(f"{label} biot_savart_pair B={B} {name}: rel_err={rel:.3e}")
                fns[label] = (lambda m: lambda: m.biot_savart_pair(*pair_args))(module)

            def two_passes():
                current.biot_savart_batch(s1, a1, J1, s2, 0.25)
                current.biot_savart_batch(s2, a2, J2, s1, 0.25)

            fns["two_batch_passes"] = two_passes
            order = list(fns) + list(fns)[::-1]
            times = collections.defaultdict(list)
            for _ in range(args.rounds):
                for label in order:
                    times[label].append(chip_smoke._timed(torch, fns[label], 10))
            bound = chip_smoke._bound("biot_savart_pair", dtype, n2, n1, B)
            for label, ms in times.items():
                mean = sum(ms) / len(ms)
                print(
                    f"turns n1={n1} n2={n2} B={B} {name} {label}: mean_ms={mean:.4f} "
                    f"turns={[round(m, 4) for m in ms]} bound_ms={bound[0]:.4f} "
                    f"share_of_bound={bound[0] / mean:.3f}"
                )
                summary["times"].append(dict(dtype=name, B=B, build=label, mean_ms=mean,
                                             turns_ms=ms, bound_ms=bound[0]))
            del ref, J1, J2
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
instead (R = H + A X with a float32 A, float64 sums), at
``chip_smoke.RESIDUAL_N`` unknowns with 1, 4 and 8 columns, beside the
widened blocked route (its plain version) and the float32 ``addmm`` that
reads the same bytes; ``--sass`` then reads ``residual_f64.cu`` and counts
the loop that holds the float64 FMAs.

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
    m = re.search(r"([a-z_0-9]+_kernel)I([fd])Li(\d+)E", fn)
    if m:
        return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}, {m.group(3)}>"
    m = re.search(r"([a-z_0-9]+_kernel)ILi(\d+)E", fn)
    return f"{m.group(1)}<{m.group(2)}>" if m else fn


def residual_turns(torch, chip_smoke, kernels, builds, rounds, summary):
    """residual_f64 of every build that has it, held against the plain
    version and timed in turns beside the widened route and the float32
    addmm, at chip_smoke.RESIDUAL_N unknowns."""
    n = chip_smoke.RESIDUAL_N
    for k in (1, 4, 8):
        A, X, H = chip_smoke._residual_inputs(torch, n, n, k, seed=77 + k)
        ref = kernels.residual_f64_plain(A, X, H)
        fns = {}
        for label, module in builds.items():
            if not hasattr(module, "residual_f64"):
                continue
            _, rel = chip_smoke._check_against_plain(
                torch, f"{label} residual_f64 k={k}", torch.float64, module.residual_f64(A, X, H), ref
            )
            print(f"{label} residual_f64 n={n} k={k}: rel_err={rel:.3e}")
            fns[label] = (lambda m: lambda: m.residual_f64(A, X, H))(module)
        x32, h32 = X.float(), H.float()
        fns["widened_blocks"] = lambda: kernels.residual_f64_plain(A, X, H)
        fns["float32_addmm"] = lambda: torch.addmm(h32, A, x32)
        order = list(fns) + list(fns)[::-1]
        times = collections.defaultdict(list)
        for _ in range(rounds):
            for label in order:
                times[label].append(chip_smoke._timed(torch, fns[label], 10))
        bound = chip_smoke._residual_bound(n, n, k)
        for label, ms in times.items():
            mean = sum(ms) / len(ms)
            print(
                f"turns residual_f64 n={n} k={k} {label}: mean_ms={mean:.4f} "
                f"turns={[round(m, 4) for m in ms]} bound_ms={bound[0]:.4f} ({bound[1]}) "
                f"share_of_bound={bound[0] / mean:.3f}"
            )
            summary["times"].append(dict(kernel="residual_f64", k=k, build=label, mean_ms=mean,
                                         turns_ms=ms, bound_ms=bound[0]))
        del A, X, H, ref
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", default=[], metavar="NAME=DIR",
                        help="another build to time beside this checkout")
    parser.add_argument("--rounds", type=int, default=1, help="A..Z Z..A passes per shape")
    parser.add_argument("--sass", metavar="DIR", help="write SASS and print ptxas counts")
    parser.add_argument("--kernel", choices=("pair", "residual"), default="pair",
                        help="the kernel to time in turns (default: biot_savart_pair)")
    args = parser.parse_args()

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
    summary = {"device": smi, "ptxas": {}, "times": []}
    if args.sass and args.kernel == "residual":
        os.makedirs(args.sass, exist_ok=True)
        for name, root in roots:
            source = Path(root) / "superscreen_tpu_torch/csrc/residual_f64.cu"
            if source.exists():
                report = ptxas_report(builds[name], source, args.sass, f"{name}_residual", "DFMA")
                summary["ptxas"][name] = report
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

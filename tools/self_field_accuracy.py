#!/usr/bin/env python3
"""How close each float32 route to a dense film's self-field ``Q (w g)``
comes to a float64 evaluation of the same float32 ``Q``.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/self_field_accuracy.py [--sites N] [--torch-device cuda|cpu]

The device is ``chip_smoke.py``'s four-ring stack (phase 2) at ``--sites``
sites per film (default 20,000), factorized and solved in float32 with
five exact coupling rounds, a 1 mT field and 1 mA in hole0.  For the
films ring0 and ring1 it prints, relative to max|exact|, the distance to
``exact = Q64 (w64 g64)`` (the float32 ``Q``, ``w`` and the solve's last
stream, widened) of:

- ``Qw @ G``: float32 ``Q diag(w)`` times the six rounds' streams as
  columns, the product ``solve()`` summed its self-field with before the
  ``residual_f64`` route;
- ``Qw @ g``: the same product with the last round's stream alone;
- ``Q @ (w g)``: the float32 product with the weights applied first, as
  the JAX package forms it;
- ``residual_f64``: ``Q diag(w)`` times ``g`` summed in float64 by the
  ``residual_f64`` kernel, the route ``solve()`` and ``solve_film`` take;
- ``solve()``: the self-field the solve reported.

With ``--torch-device cpu`` the same runs on the CPU's plain versions (a
rehearsal at a few hundred sites).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import superscreen_tpu_torch as st  # noqa: E402
from superscreen_tpu_torch.ops import kernels  # noqa: E402
from superscreen_tpu_torch.solver.utils import field_conversion_factor, make_film_info  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sites", type=int, default=chip_smoke.SITES_DENSE)
    parser.add_argument("--torch-device", default="cuda")
    args = parser.parse_args()
    where = args.torch_device
    device = chip_smoke.four_ring_stack(st, args.sites)
    with chip_smoke._exact_coupling():
        model = st.factorize_model(
            device=device, current_units="uA", circulating_currents={"hole0": "1 mA"},
            torch_device=where,
        )
        solutions = st.solve(
            model=model, applied_field=st.sources.ConstantField(1.0),
            iterations=chip_smoke.ITERATIONS, torch_device=where, progress_bar=False,
        )
    conv = field_conversion_factor(
        "mT", "uA", length_units=device.length_units, ureg=device.ureg
    ).magnitude
    for name in ("ring0", "ring1"):
        info = make_film_info(
            device=device, circulating_currents=model.circulating_currents,
            torch_device=where, films=[name],
        )[name]
        Q, w, Qw = info.kernel, info.weights, model.film_data[name].Qw
        G = torch.stack([
            torch.as_tensor(s.film_solutions[name].stream, device=where) for s in solutions
        ])
        g = G[-1]
        exact = Q.double() @ (w.double() * g.double())
        scale = float(exact.abs().max())
        routes = {
            "Qw @ G (six columns)": (Qw @ G.T).T[-1],
            "Qw @ g": (Qw @ g[:, None])[:, 0],
            "Q @ (w g)": Q @ (w * g),
            "residual_f64": kernels.residual_f64(Qw, g[:, None])[:, 0],
            "solve()": torch.as_tensor(
                solutions[-1].film_solutions[name].self_field, device=where
            ).double() * conv,
        }
        for label, value in routes.items():
            err = float((value.double() - exact).abs().max()) / scale
            print(f"self_field {name} n={len(g)} {label}: {err:.3e} of max|exact|")
        del info, Q, exact
        if where == "cuda":
            torch.cuda.empty_cache()
    if where == "cuda":
        print(
            "device: "
            + chip_smoke.subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True,
            ).stdout.strip()
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

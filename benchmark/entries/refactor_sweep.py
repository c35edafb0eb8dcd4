"""The kind of call ``refactor_sweep``: a new Lambda per layer, the model
factorized anew, then a sweep: one model per call."""

import math
from typing import List

from benchmark.drives import Check, _Stack


class RefactorSweep(_Stack):
    """A new homogeneous Lambda for each layer, drawn as ``lambda_scale``
    times the configuration's, then ``factorize_model`` and a
    ``solve_many`` sweep as :class:`SolveMany`'s: one model per call."""

    models_per_call = 1

    def points(self, params):
        return len(params[1])

    def draw(self, rng):
        layers = self.config["devices"]["stack"]["layers"]
        scale = self.uniform(rng, "lambda_scale", len(layers))
        lam = {l["name"]: float(l["Lambda"] * s) for l, s in zip(layers, scale)}
        return lam, self.uniform(rng, "field_mT", int(self.traffic["points_per_call"]))

    def call(self, params):
        lam, fields = params
        for name, value in lam.items():
            self.device.layers[name].Lambda = value
        self.model = None  # the previous model's tensors go before the next is built
        self.model = self.factorize()
        return self.sweep(fields)

    def check(self, kept, device) -> List[Check]:
        err = float("nan")
        for (lam, fields), out in kept:
            basis = self.reference_basis(lam, device=device)
            e = self.stream_error(out, fields, basis)
            err = e if math.isnan(err) else max(err, e)
        return [Check("stream_rel_err", err, self.config["limits"]["stream_rel_err"])]

    def control(self, draws, device) -> List[float]:
        out = []
        for lam, fields in draws:
            basis64 = self.reference_basis(lam, device=device)
            g = self.control_streams(fields, lam, device)
            out.append(self.stream_error({n: v.T for n, v in g.items()}, fields, basis64))
        return out


ENTRY = RefactorSweep

"""The kind of call ``transport_sweep``: a bias sweep of a film with
transport terminals under a ring, with trapped vortices and a weak spot in
each layer's Lambda, through ``factorize_model(vortices=)`` and
``solve_many(terminal_currents=, circulating_currents=, vortex_nPhi0=)``."""

from typing import List

import numpy as np

from benchmark.devices import build_device
from benchmark.drives import Check, Entry
from benchmark.reference import films as ref
from benchmark.reference.transport import TransportStack


def weak_spot(x, y, x0=0.0, y0=0.0, sigma=2.0, depth=0.5, base=1.0):
    """A penetration depth ``base`` with a Gaussian weak spot: larger by the
    fraction ``depth`` at ``(x0, y0)``, of width ``sigma``."""
    return base * (1 + depth * np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2)))


def strip_polygons(st, sites: int, width: float = 20.0, height: float = 8.0) -> dict:
    """The strip's outline, its hole and its two terminals, drawn for a mesh
    of ``sites`` sites as ``chip_smoke.transport_stack`` draws them: a film
    with terminals keeps its boundary as given, so the outline and the hole
    are drawn at the mesh's edge length ``h``, and each terminal (``h / 4``
    wide on a short edge) owns the vertices of that edge only.  The
    configuration file holds them as drawn at 20,000 sites."""
    h = np.sqrt(2 * width * height / (np.sqrt(3) * sites))
    return {
        "strip": st.geometry.box(width, height, points=int(2 * (width + height) / h)),
        "strip_hole": st.geometry.circle(1.5, points=int(2 * np.pi * 1.5 / h), center=(-5.0, 0.0)),
        "source": st.geometry.box(h / 4, height, center=(-width / 2, 0)),
        "drain": st.geometry.box(h / 4, height, center=(width / 2, 0)),
    }


class TransportSweep(Entry):
    """``solve_many`` of ``points_per_call`` points against the model
    factorized in set-up: at each point a bias current drawn from
    ``bias_uA`` into the source terminal and out of the drain, integer
    vortex amplitudes drawn from ``vortex_nPhi0`` (inclusive bounds) for
    each trapped vortex, and a current drawn from ``hole_current_uA`` in the
    swept hole; one uniform field drawn from ``field_mT`` per call.  The
    check compares both films' streams after the last coupling round, and
    the terminal film's self-field, at every point of each sampled call."""

    def setup(self, st):
        self.st = st
        c = self.config
        spec = c["devices"]["stack"]
        self.device = build_device(st, "stack", spec, c["solve_dtype"])
        # The file keeps each layer's scalar base in ``Lambda`` (what
        # ``build_device`` reads); the weak spot makes it a Parameter.
        for layer in spec["layers"]:
            self.device.layers[layer["name"]].Lambda = st.Parameter(
                weak_spot, base=float(layer["Lambda"]), **layer["weak_spot"]
            )
        vortices = [st.Vortex(x=v["x"], y=v["y"], film=v["film"]) for v in c["vortices"]]
        self.model = st.factorize_model(
            device=self.device, current_units=c["current_units"], vortices=vortices,
            torch_device=self.torch_device,
        )

    def points(self, params):
        return len(params["bias"])

    def draw(self, rng):
        B = int(self.traffic["points_per_call"])
        lo, hi = self.traffic["vortex_nPhi0"]
        return {
            "bias": self.uniform(rng, "bias_uA", B),
            "vortex_nPhi0": rng.integers(lo, hi + 1, (B, len(self.config["vortices"]))).astype(float),
            "hole_current": self.uniform(rng, "hole_current_uA", B),
            "field": float(self.uniform(rng, "field_mT")),
        }

    def call(self, params):
        c = self.config
        bias = c["bias"]
        terminal = [
            {bias["film"]: {bias["source"]: float(I), bias["drain"]: -float(I)}} for I in params["bias"]
        ]
        circulating = [{c["swept_hole"]: float(I)} for I in params["hole_current"]]
        result = self.st.solve_many(
            model=self.model,
            applied_fields=[self.st.sources.ConstantField(params["field"])] * len(terminal),
            terminal_currents=terminal, circulating_currents=circulating,
            vortex_nPhi0=params["vortex_nPhi0"], field_units=c["field_units"],
            iterations=c["iterations"], coupling=c["coupling"], torch_device=self.torch_device,
        )
        return {
            "streams": {name: np.array(s) for name, s in result.streams.items()},
            "self_field": np.array(result.self_fields[bias["film"]]),
        }

    def reference(self, prec, device) -> TransportStack:
        return TransportStack(self.config, prec, device)

    @staticmethod
    def rel_err(got: np.ndarray, want: np.ndarray) -> float:
        """Largest ``max|x - x_ref| / max|x_ref|`` over the points (rows)."""
        return float(max(np.abs(g - w).max() / np.abs(w).max() for g, w in zip(got, want)))

    def errors(self, out, want) -> dict:
        """``stream_rel_err`` (over films and points) and
        ``self_field_rel_err`` of one call against the reference's."""
        return {
            "stream_rel_err": max(self.rel_err(out["streams"][n], want["streams"][n]) for n in want["streams"]),
            "self_field_rel_err": self.rel_err(out["self_field"], want["self_field"]),
        }

    def check(self, kept, device) -> List[Check]:
        reference = self.reference(ref.F64, device)
        worst = dict.fromkeys(self.config["limits"], float("nan"))
        for params, out in kept:
            for name, value in self.errors(out, reference.sweep(params)).items():
                worst[name] = value if np.isnan(worst[name]) else max(worst[name], value)
        return [Check(name, value, self.config["limits"][name]) for name, value in worst.items()]

    def control_errors(self, draws, device) -> List[dict]:
        """Both numbers of the control for each drawn call: the reference in
        TF32 put in the program's place, judged as the program is."""
        exact = self.reference(ref.F64, device)
        want = [exact.sweep(p) for p in draws]
        del exact
        tf32 = self.reference(ref.TF32, device)
        return [self.errors(tf32.sweep(p), w) for p, w in zip(draws, want)]

    def control(self, draws, device) -> List[float]:
        """The control's ``stream_rel_err`` for each drawn call (the first of
        the file's limits, which ``control.py`` prints beside it)."""
        return [e["stream_rel_err"] for e in self.control_errors(draws, device)]


ENTRY = TransportSweep

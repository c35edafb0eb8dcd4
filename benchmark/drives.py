"""The one general generator of the benchmark's traffic.  A traffic mix is
a JSON file under ``benchmark/traffic`` whose ``entry`` names the public
entry of the program that each call of the window drives, and whose other
keys are the parameters the calls are drawn from (``--seed`` seeds every
draw).  Each entry also knows how to check what its calls returned against
the plain reference (:mod:`benchmark.reference`).

The window is a closed loop with one client: a designer's script that
waits for each call before it makes the next.
"""

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np

from .devices import build_device
from .reference import films as ref
from .reference.config import FIELD_PER_MT, MU_0, PHI_0, film_meshes
from .reference.mesh import circle, closed_ccw


@dataclass
class Check:
    """One number compared, with its limit: ``correct`` needs
    ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Entry:
    """A kind of call: ``setup`` builds what every call shares (the
    program's model), ``draw`` the parameters of the next call from the
    seeded generator, ``call`` drives the program once and returns what a
    check needs (host arrays), ``points`` the drive points of one call and
    ``check`` the reference's verdict on a sample of calls."""

    models_per_call = 0

    def __init__(self, config: dict, traffic: dict, torch_device: str):
        self.config, self.traffic, self.torch_device = config, traffic, torch_device

    def release(self):
        """Drops the program's state (its model and solutions) before the
        reference runs on the same card."""
        self.model = self.squid_solution = None

    def uniform(self, rng, key, size=None):
        lo, hi = self.traffic[key]
        return rng.uniform(lo, hi, size)


class _Stack(Entry):
    """Calls on a stack of films with circulating currents in a uniform
    applied field; the check compares every film's stream after the last
    coupling round at every point of each sampled call."""

    def setup(self, st):
        self.st = st
        c = self.config
        self.device = build_device(st, "stack", c["devices"]["stack"], c["solve_dtype"])
        self.model = self.factorize()

    def factorize(self):
        c = self.config
        return self.st.factorize_model(
            device=self.device, current_units=c["current_units"],
            circulating_currents=dict(c["circulating_currents"]), torch_device=self.torch_device,
        )

    def sweep(self, fields):
        c = self.config
        result = self.st.solve_many(
            model=self.model, applied_fields=[self.st.sources.ConstantField(b) for b in fields],
            field_units=c["field_units"], iterations=c["iterations"], coupling=c["coupling"],
            torch_device=self.torch_device,
        )
        return {name: np.array(s) for name, s in result.streams.items()}

    def reference_basis(self, Lambda=None, prec=ref.F64, device="cpu"):
        c = self.config
        films = film_meshes(c["devices"]["stack"], Lambda)
        return ref.stack_basis(films, FIELD_PER_MT, c["circulating_currents"], c["iterations"], prec, device)

    @staticmethod
    def stream_error(streams: Dict[str, np.ndarray], fields, basis) -> float:
        """Largest ``max|g - g_ref| / max|g_ref|`` over films and points."""
        worst = 0.0
        for name, g in streams.items():
            gb = basis[name].numpy()
            for k, b in enumerate(fields):
                want = b * gb[:, 0] + gb[:, 1]
                worst = max(worst, float(np.abs(g[k] - want).max() / np.abs(want).max()))
        return worst

    def check(self, kept, device) -> List[Check]:
        basis = self.reference_basis(device=device)
        err = max((self.stream_error(out, p, basis) for p, out in kept), default=float("nan"))
        return [Check("stream_rel_err", err, self.config["limits"]["stream_rel_err"])]

    def control(self, draws, device) -> List[float]:
        """The control's reading for each drawn call: the reference in TF32
        put in the program's place, judged as the program is."""
        basis64 = self.reference_basis(device=device)
        fields = np.concatenate([np.atleast_1d(p) for p in draws])
        g = self.control_streams(fields, None, device)
        out, k = [], 0
        for p in draws:
            b = np.atleast_1d(p)
            out.append(self.stream_error({n: v[:, k:k + len(b)].T for n, v in g.items()}, b, basis64))
            k += len(b)
        return out

    def control_streams(self, fields, Lambda, device):
        c = self.config
        films = film_meshes(c["devices"]["stack"], Lambda)
        systems = [ref.FilmSystem(f, ref.TF32, device) for f in films]
        Hz, I = {}, {}
        for s in systems:
            Hz[s.film.name] = FIELD_PER_MT * torch_ones(s, fields)
            I[s.film.name] = torch_currents(s, c["circulating_currents"], len(fields))
        return {n: g.double().cpu().numpy() for n, g in ref.coupled_streams(systems, Hz, I, c["iterations"]).items()}


def torch_ones(system, fields):
    import torch

    return torch.ones((system.n, 1), dtype=system.prec.dtype, device=system.sites.device) * torch.as_tensor(
        np.asarray(fields), dtype=system.prec.dtype, device=system.sites.device)[None, :]


def torch_currents(system, currents, B):
    import torch

    return torch.tensor(
        [[currents.get(h, 0.0)] * B for h in system.hole_names], dtype=system.prec.dtype,
        device=system.sites.device,
    ).reshape(len(system.hole_names), B)


class SolveMany(_Stack):
    """``solve_many`` over ``points_per_call`` uniform fields drawn from
    ``field_mT``, against the model factorized in set-up."""

    def points(self, params):
        return len(params)

    def draw(self, rng):
        return self.uniform(rng, "field_mT", int(self.traffic["points_per_call"]))

    def call(self, params):
        return self.sweep(params)


class Solve(_Stack):
    """``solve`` of one uniform field drawn from ``field_mT``; the last
    round's streams are kept."""

    def points(self, params):
        return 1

    def draw(self, rng):
        return self.uniform(rng, "field_mT", 1)

    def call(self, params):
        c = self.config
        solutions = self.st.solve(
            model=self.model, applied_field=self.st.sources.ConstantField(float(params[0])),
            field_units=c["field_units"], iterations=c["iterations"], coupling=c["coupling"],
            progress_bar=False, torch_device=self.torch_device,
        )
        return {name: np.array(fs.stream)[None] for name, fs in solutions[-1].film_solutions.items()}


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


class SusceptibilityScan(Entry):
    """``squids.scanning.susceptibility_scan`` of the sample model
    factorized in set-up, the SQUID solved in set-up: ``positions`` points
    on a line across ``x_um`` at a lateral offset drawn from ``y_um``.  The
    check compares the susceptibility at every position of each sampled
    scan."""

    def setup(self, st):
        from superscreen_tpu_torch.squids import scanning

        self.st, self.scanning = st, scanning
        c = self.config
        squid = build_device(st, "squid", c["devices"]["squid"], c["solve_dtype"])
        sample = build_device(st, "sample", c["devices"]["sample"], c["solve_dtype"])
        self.squid_solution = st.solve(
            squid, applied_field=st.sources.ConstantField(0), circulating_currents=dict(c["squid_currents"]),
            field_units="mT", current_units=c["squid_current_units"], progress_bar=False,
            torch_device=self.torch_device,
        )[-1]
        self.model = st.factorize_model(device=sample, current_units=c["current_units"], torch_device=self.torch_device)

    def positions(self, y):
        B = int(self.traffic["positions"])
        return np.column_stack([np.linspace(*self.traffic["x_um"], B), np.full(B, float(y))])

    def points(self, params):
        return int(self.traffic["positions"])

    def draw(self, rng):
        return float(self.uniform(rng, "y_um"))

    def call(self, params):
        c = self.config
        return np.array(self.scanning.susceptibility_scan(
            sample_model=self.model, squid_solution=self.squid_solution, positions=self.positions(params),
            squid_height=c["squid_height"], pickup_loop=c["pickup_loop"], I_fc=c["I_fc_A"],
            iterations=c["iterations"], back_action=c["back_action"], coupling=c["coupling"],
            torch_device=self.torch_device,
        ))

    def reference_scan(self, ys, prec, device) -> List[np.ndarray]:
        """The response map (Phi_0 / A) at each offset in ``ys``."""
        c = self.config
        squid_spec = c["devices"]["squid"]
        (squid_film,) = film_meshes(squid_spec)
        (sample_film,) = film_meshes(c["devices"]["sample"])
        squid, J = ref.squid_current(squid_film, c["squid_currents"], prec, device)
        sample = ref.FilmSystem(sample_film, prec, device)
        loop = next(p for p in squid_spec["abstract_regions"] + squid_spec["holes"] if p["name"] == c["pickup_loop"])
        layers = {l["name"]: l for l in squid_spec["layers"]}
        contour = closed_ccw(circle(*loop["circle"]))
        # Squid currents in the sample's current units (both length units um).
        scale = {"mA": 1e3, "uA": 1.0}[c["squid_current_units"]] / {"mA": 1e3, "uA": 1.0}[c["current_units"]]
        unit = {"mA": 1e-3, "uA": 1e-6}[c["current_units"]]
        out = []
        for y in ys:
            flux = ref.scan_response(
                squid, J, sample, self.positions(y), c["squid_height"], contour,
                float(layers[loop["layer"]]["z0"]), scale,
            ).numpy()
            out.append(flux * MU_0 * unit * 1e-6 / c["I_fc_A"] / PHI_0)
        return out

    @staticmethod
    def scan_error(M, want) -> float:
        return float(np.abs(M - want).max() / np.abs(want).max())

    def check(self, kept, device) -> List[Check]:
        refs = self.reference_scan([y for y, _ in kept], ref.F64, device)
        err = max((self.scan_error(M, want) for (_, M), want in zip(kept, refs)), default=float("nan"))
        return [Check("susceptibility_rel_err", err, self.config["limits"]["susceptibility_rel_err"])]

    def control(self, draws, device) -> List[float]:
        refs = self.reference_scan(draws, ref.F64, device)
        ctrl = self.reference_scan(draws, ref.TF32, device)
        return [self.scan_error(M, want) for M, want in zip(ctrl, refs)]


ENTRIES: Dict[str, Callable[..., Entry]] = {
    "solve_many": SolveMany,
    "solve": Solve,
    "refactor_sweep": RefactorSweep,
    "susceptibility_scan": SusceptibilityScan,
}


class Reservoir:
    """A uniform sample of at most ``size`` of the calls offered, drawn
    from its own seeded generator (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, np.random.default_rng([seed, 1]), [], 0

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1

"""The one general generator of the benchmark's traffic.  A traffic mix is
a JSON file under ``benchmark/traffic`` whose ``entry`` names the kind of
call that each call of the window makes, and whose other keys are the
parameters the calls are drawn from (``--seed`` seeds every draw).  Each
kind of call is a file ``benchmark/entries/<entry>.py`` whose ``ENTRY`` is
an :class:`Entry` subclass, found by that name
(:func:`benchmark.harness.entry_class`): it drives a public entry of the
program and knows how to check what its calls returned against the plain
reference (:mod:`benchmark.reference`).  This module holds what the kinds
share.

The window is a closed loop with one client: a designer's script that
waits for each call before it makes the next.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .devices import build_device
from .reference import films as ref
from .reference.config import FIELD_PER_MT, film_meshes


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
    ``check`` the reference's verdict on a sample of calls.

    ``cards`` are the cell's cards; the first, ``torch_device``, is the one
    the program's model lives on and the reference runs on, and the others
    are for a kind of call that spreads its work."""

    models_per_call = 0
    sharding = None

    def __init__(self, config: dict, traffic: dict, cards: Sequence[str]):
        self.config, self.traffic, self.cards = config, traffic, list(cards)
        self.torch_device = self.cards[0]

    def release(self):
        """Drops the program's state (its model, solutions and mesh) before
        the reference runs on the same card."""
        self.model = self.squid_solution = self.sharding = None

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
            sharding=self.sharding, torch_device=self.torch_device,
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

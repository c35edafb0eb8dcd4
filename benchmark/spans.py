"""Spans and counters of a traced run, recorded from the benchmark's own
files: each wrapper is installed where the program looks the function up
(a module attribute), for the traced run only, and removed after it.

Device spans are ``torch.profiler.record_function`` ranges named
``bench.<layer>``; the profiler attributes to them the device time of the
kernels launched inside.  Each call also records the least time its work
could take on the card (:mod:`benchmark.rates`), from its shapes.  Program
spans (``scan_maps``, ``factorize``, ``factor``) are wall times on the host
clock between two synchronizations.
"""

import contextlib
import functools
import time
from collections import defaultdict

from . import rates


class Spans:
    """What the wrappers recorded: ``least_ms[span]`` the summed least
    time of the span's calls, ``wall_s[span]`` the host wall of each call of
    a program span, and ``factorize`` one record per model."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.least_ms = defaultdict(float)
        self.wall_s = defaultdict(list)
        self.factorize = []


def _dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


def _coupling_least_ms(film_data, films, Js, coupling) -> float:
    """Two one-way ``biot_savart_batch`` passes per film pair, one for each
    direction, at the round's column count."""
    if coupling != "exact":
        return float("nan")
    total = 0.0
    for a in films:
        for b in films:
            if a != b:
                J = Js[a]
                B = J.shape[0] if J.ndim == 3 else 1
                total += rates.pairwise_bound(
                    "biot_savart_batch", _dtype_name(J), film_data[b].n, film_data[a].n, B
                )[0]
    return total


def _film_solve_least_ms(data, Hz_total, refine_steps) -> float:
    """One product with the stored factors per solve (an explicit inverse,
    or the two triangles of an LU), and one ``residual_f64`` pass over
    ``A`` per residual, as the refinement makes them: ``1 + s`` solves, and
    ``1 + s`` residuals when it refines ``s > 0`` times."""
    if data.fac_kind not in ("inv", "lu", "chol"):
        return float("nan")
    ni = int(data.interior.shape[0])
    B = int(Hz_total.shape[0])
    size = Hz_total.element_size()
    solves = 1 + refine_steps
    residuals = 1 + refine_steps if refine_steps else 0
    return (
        solves * rates.apply_bound(ni, B, size)[0]
        + residuals * rates.residual_bound(ni, ni, B, size, size, size)[0]
    )


@contextlib.contextmanager
def installed(spans: Spans):
    """Installs the wrappers on the program's modules for the duration."""
    import torch
    from torch.profiler import record_function

    import superscreen_tpu_torch as st
    from superscreen_tpu_torch import sweep
    from superscreen_tpu_torch.ops import linalg
    from superscreen_tpu_torch.squids import scanning

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def coupling_round(fn):
        @functools.wraps(fn)
        def wrapper(film_data, films, streams, Js, Hz_applied, coupling="exact"):
            spans.least_ms["bench.coupling"] += _coupling_least_ms(film_data, films, Js, coupling)
            with record_function("bench.coupling"):
                return fn(film_data, films, streams, Js, Hz_applied, coupling)
        return wrapper

    def solve_film_batch(fn):
        @functools.wraps(fn)
        def wrapper(data, Hz_total, I_circ, vortex_flux, refine_steps=2, check_inversion=False):
            spans.least_ms["bench.film_solve"] += _film_solve_least_ms(data, Hz_total, refine_steps)
            with record_function("bench.film_solve"):
                return fn(data, Hz_total, I_circ, vortex_flux, refine_steps, check_inversion)
        return wrapper

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            with record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
            sync()
            spans.wall_s[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    def factorize(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            record = {"factor_s": 0.0}
            spans.factorize.append(record)
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            record["wall_s"] = time.perf_counter() - t0
            return out
        return wrapper

    def factor_system(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            if spans.factorize:
                spans.factorize[-1]["factor_s"] += time.perf_counter() - t0
            return out
        return wrapper

    patches = [
        (sweep, "_coupling_round", coupling_round),
        (sweep, "_solve_film_batch", solve_film_batch),
        (scanning, "applied_field_maps", functools.partial(timed, "scan_maps")),
        (st, "factorize_model", factorize),
        (linalg, "factor_system", factor_system),
    ]
    saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
    try:
        for module, name, wrap in patches:
            setattr(module, name, wrap(getattr(module, name)))
        yield spans
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)

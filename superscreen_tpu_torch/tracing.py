"""Spans and host-transfer counters of the port's entry calls, recorded
only while a ``torch.profiler`` profile is open.

A span marks a layer boundary inside :func:`~superscreen_tpu_torch.solve_many`,
:func:`~superscreen_tpu_torch.solve`,
:func:`~superscreen_tpu_torch.factorize_model` and
:func:`~superscreen_tpu_torch.squids.scanning.susceptibility_scan`.  While
a profiler runs (``torch.autograd.profiler._is_profiler_enabled``), each
span

- opens a ``torch._C._profiler._RecordFunctionFast`` range of its name,
  so that it appears in the profiler's trace as a host operation
  (``cpu_op``) on the clock of the device's kernels.  Unlike
  ``torch.profiler.record_function``, such a range makes no device-side
  event;
- appends a :class:`Span` to an in-memory list: its name, host start and
  end (``time.perf_counter_ns``), the index of the span it was opened in,
  and the id of the entry call it belongs to.  An entry call opened with
  no span open takes a new id; every span opened inside it, nested entry
  calls included (the scan's ``solve_many``), shares that id.

Counters (:data:`D2H_BYTES`, :data:`H2D_BYTES`, :data:`HOST_SYNCS`) are
added at the host-transfer sites of these calls, through :func:`to_host`
and :func:`to_device`, only for copies that cross between the host and a
card, and only while a profiler runs.  :data:`POLYGON_CHECKS` counts the
simplicity checks that a :class:`~superscreen_tpu_torch.Polygon` runs on
its ring: one when a ring is set, and one when
:attr:`~superscreen_tpu_torch.Polygon.is_valid` finds the ring's bytes
changed since it last passed.  :data:`TERMINAL_SOLVES` counts the solves
of a terminal film's transport bootstrap
(:func:`~superscreen_tpu_torch.solver.solve_film.solve_from_boundary_stream`),
and :data:`TRIANGULAR_SOLVES` the solves that run on packed LU factors
(:func:`~superscreen_tpu_torch.ops.linalg.lu_solve`).  Each increment is also attributed to the innermost open span
(:attr:`Span.counts`).

With no profiler running, a span or a counter costs one boolean test: it
records and allocates nothing.  Spans add no synchronization and no device
work.  Nothing is written to disk: :func:`snapshot` returns what was
recorded, :func:`reset` clears it, and the profiler's own chrome trace
(``export_chrome_trace``) shows the spans over the kernels.  The recorder
serves the thread that makes the calls.

The counters kept elsewhere, ``ops.cuda_kernels.LAUNCHES``,
``ops.linalg.CG_STATS`` and ``native.STATS``, count at all times;
:func:`snapshot` hands them on as they are.
"""

import contextlib
import functools
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

__all__ = [
    "D2H_BYTES",
    "H2D_BYTES",
    "HOST_SYNCS",
    "POLYGON_CHECKS",
    "Span",
    "TERMINAL_SOLVES",
    "TRIANGULAR_SOLVES",
    "count",
    "reset",
    "snapshot",
    "span",
    "to_device",
    "to_host",
    "traced",
]

#: Bytes copied from a card to the host.
D2H_BYTES = "d2h_bytes"
#: Bytes copied from the host to a card.
H2D_BYTES = "h2d_bytes"
#: Blocking reads of device values (``.cpu()``, ``.item()``, ``float()``,
#: ``bool()`` of a tensor on a card).
HOST_SYNCS = "host_syncs"
#: Runs of ``polygon_ops.is_simple_polygon`` on a polygon's ring.
POLYGON_CHECKS = "polygon_checks"
#: Refined LU solves of a terminal film's transport bootstrap: one with the
#: boundary fixed, and one more with the holes pinned where the film has
#: holes.
TERMINAL_SOLVES = "terminal_solves"
#: Solves on packed LU factors (two triangular solves each,
#: ``ops.linalg.lu_solve``): a film system on the CPU or of at most
#: ``ops.linalg.LU_MAX_N_TPU`` unknowns.
TRIANGULAR_SOLVES = "triangular_solves"

@dataclass(eq=False)
class Span:
    """One recorded span: ``parent`` is the index in the list of the span it
    was opened in (None at the top), ``call`` the id of its entry call
    (None outside any), ``end_ns`` None while it is open, and ``counts``
    the counter increments made while it was the innermost open span."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    call: Optional[int]
    counts: Dict[str, int] = field(default_factory=dict)


_spans: List[Span] = []
_counters: Dict[str, int] = {}
#: The open spans, innermost last, each with its index in ``_spans``.
_open: List[Tuple[Span, int]] = []
_call_ids = itertools.count()


class _Record:
    """The context of one span while a profiler runs."""

    __slots__ = ("name", "entry", "record", "fast")

    def __init__(self, name: str, entry: bool):
        self.name, self.entry = name, entry

    def __enter__(self):
        if _open:
            outer, parent = _open[-1]
            call = outer.call
        else:
            parent = None
            call = next(_call_ids) if self.entry else None
        self.fast = torch._C._profiler._RecordFunctionFast(self.name)
        self.fast.__enter__()
        self.record = Span(self.name, time.perf_counter_ns(), None, parent, call)
        _open.append((self.record, len(_spans)))
        _spans.append(self.record)
        return self.record

    def __exit__(self, *exc):
        self.record.end_ns = time.perf_counter_ns()
        if _open and _open[-1][0] is self.record:
            _open.pop()
        self.fast.__exit__(None, None, None)
        return False


_NOTHING = contextlib.nullcontext()


def span(name: str, entry: bool = False):
    """A context manager that records the span ``name`` while a profiler
    runs, and does nothing otherwise.  ``entry`` marks an entry call: it
    takes a new call id when no span is open."""
    if not _profiler._is_profiler_enabled:
        return _NOTHING
    return _Record(name, entry)


def traced(name: str, entry: bool = False):
    """Decorates a function so that each call is the span ``name``; the
    function keeps its name, signature and docstring."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Record(name, entry):
                return fn(*args, **kwargs)

        return wrapper

    return wrap


def count(counter: str, value: int = 1) -> None:
    """Adds ``value`` to ``counter`` and to the innermost open span's count
    while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return
    _counters[counter] = _counters.get(counter, 0) + value
    if _open:
        counts = _open[-1][0].counts
        counts[counter] = counts.get(counter, 0) + value


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``; where ``t`` lives on a card, counted as a blocking
    read of its bytes.  Wrap it for a scalar read: ``float(to_host(x))``."""
    if t.device.type != "cpu" and _profiler._is_profiler_enabled:
        count(D2H_BYTES, _nbytes(t))
        count(HOST_SYNCS)
    return t.cpu()


def to_device(value, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``value`` (a tensor, an array or nested lists) as a tensor on
    ``device`` (in ``dtype`` if given): ``value.to(...)`` for a tensor,
    ``torch.as_tensor(...)`` otherwise.  Counted where host data crosses to
    a card."""
    if torch.is_tensor(value):
        out = value.to(device=device, dtype=dtype)
        crossed = value.device.type == "cpu"
    else:
        out = torch.as_tensor(value, dtype=dtype, device=device)
        crossed = True
    if crossed and out.device.type != "cpu" and _profiler._is_profiler_enabled:
        count(H2D_BYTES, _nbytes(out))
    return out


def snapshot() -> dict:
    """What was recorded since the last :func:`reset`: ``spans`` (a list of
    :class:`Span`, parents before their children), ``counters``
    (``{counter: total}``), and the package's always-on counters by
    reference: ``launches`` (``ops.cuda_kernels.LAUNCHES``), ``cg``
    (``ops.linalg.CG_STATS``) and ``native`` (``native.STATS``)."""
    from . import native
    from .ops import cuda_kernels, linalg

    return {
        "spans": list(_spans),
        "counters": dict(_counters),
        "launches": cuda_kernels.LAUNCHES,
        "cg": linalg.CG_STATS,
        "native": native.STATS,
    }


def reset() -> None:
    """Clears the recorded spans and counters.  A span open at the time is
    not recorded further."""
    _spans.clear()
    _counters.clear()
    _open.clear()

"""Reduction of a ``torch.profiler`` trace of the measured window, card by
card: each card's busy time (the union of the intervals in which an
operation ran on it), the kernel launches, the device time under each
benchmark span, the operations that took the most device time, and the
idle gaps by what the host was doing when they began.  Busy time, the
operations' times and the idle gaps are means over the cell's cards;
launches and the device time under a span are sums over them."""

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

TOP = 10
NAME_CHARS = 120


@dataclass
class Trace:
    busy_s: float
    kernels: int
    span_device_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    busy_s_per_card: List[float]


def _union(intervals):
    """Total length and the merged list of ``(start, end)`` intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), merged


def _overlap(merged, intervals) -> float:
    """Total length of ``intervals`` covered by the sorted, disjoint
    ``merged`` intervals."""
    starts = [m[0] for m in merged]
    total = 0.0
    for start, end in intervals:
        i = max(bisect.bisect_right(starts, start) - 1, 0)
        while i < len(merged) and merged[i][0] < end:
            total += max(0.0, min(end, merged[i][1]) - max(start, merged[i][0]))
            i += 1
    return total


def _host_labels(cpu, times):
    """For each of the ascending ``times``, what the host was doing: the
    innermost of the nested ``cpu`` events ``(start, end, name)`` in
    progress, behind the innermost ``bench.*`` span around it."""
    events = sorted(cpu, key=lambda e: (e[0], -e[1]))
    stack, out, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if not stack:
            out.append("host outside any operation")
            continue
        inner = stack[-1][2]
        span = next((e[2] for e in reversed(stack) if e[2].startswith("bench.")), None)
        out.append((f"{span} > {inner}" if span and span != inner else inner)[:NAME_CHARS])
    return out


def _by_card(events):
    """``{card: [(start, end, name), ...]}`` of events ``(start, end, name,
    card)``."""
    out = defaultdict(list)
    for start, end, name, card in events:
        out[card].append((start, end, name))
    return out


def reduce_events(device, annotations, cpu, cards=None) -> Trace:
    """The :class:`Trace` of the device operations ``(start, end, name,
    card)``, the device side of the ``bench.*`` ranges ``(start, end, name,
    card)`` (the profiler's GPU user annotations, from the first to
    the last operation each range launched on that card: a range, not work)
    and the host events of the thread that drove the window ``(start, end,
    name)``, times in seconds.  ``cards`` are the cell's card indices
    (default: those that ran an operation); a card that ran nothing is idle
    all the window.  The device time under a span is each card's busy time
    inside its ranges on that card, summed over the cards."""
    ops, ranges_by_card = _by_card(device), _by_card(annotations)
    cards = sorted(cards if cards is not None else ops) or [0]
    busy, spans = [], defaultdict(float)
    per_op, gaps = defaultdict(float), defaultdict(float)
    for card in cards:
        events = ops.get(card, [])
        total, merged = _union((e[0], e[1]) for e in events)
        busy.append(total)
        for start, end, name in events:
            per_op[name[:NAME_CHARS]] += (end - start) / len(cards)
        ranges = defaultdict(list)
        for start, end, name in ranges_by_card.get(card, []):
            ranges[name].append((start, end))
        for name, r in ranges.items():
            spans[name] += _overlap(merged, sorted(r))
        ends = [m[1] for m in merged[:-1]]
        for (_, end), (start, _), label in zip(merged[:-1], merged[1:], _host_labels(cpu, ends)):
            gaps[label] += (start - end) / len(cards)
    kernels = sum(1 for e in device if not e[2].startswith(("Memcpy", "Memset")))
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(
        busy_s=sum(busy) / len(busy), kernels=kernels, span_device_s=dict(spans),
        device_ops=[[k, v] for k, v in top], idle_gaps=[[k, v] for k, v in idle], busy_s_per_card=busy,
    )


def reduce(prof, cards=None) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` over the
    card indices ``cards``, read from the profiler's raw events (a device
    event's card is its ``device_index``; the host thread that drove the
    window is the one with the most events)."""
    from torch.autograd import DeviceType

    raw = [
        (e.start_ns(), e.end_ns(), e.name(), e.device_type(), e.start_thread_id(), e.device_index())
        for e in prof.profiler.kineto_results.events()
    ]
    base = min((r[0] for r in raw), default=0)
    device, annotations, cpu = [], [], defaultdict(list)
    for start, end, name, kind, thread, card in raw:
        item = ((start - base) / 1e9, (end - base) / 1e9, name)
        if kind == DeviceType.CUDA:
            (annotations if name.startswith("bench.") else device).append(item + (card,))
        elif kind == DeviceType.CPU:
            cpu[thread].append(item)
    main = max(cpu, key=lambda k: len(cpu[k])) if cpu else None
    return reduce_events(device, annotations, cpu.get(main, []), cards)

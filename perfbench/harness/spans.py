"""The program's own spans in a profiler trace, and the device's idle
time inside each.

The program (``repro_torch.trace``, when enabled) wraps its
phases in ``torch.profiler.record_function("repro::<name>")`` ranges.
Kineto copies every such range onto the GPU timeline as a device-side
user annotation, which ``trace.from_profiler`` would count as a kernel
(it skips only ``perfbench::`` names there), so busy time would grow by
the ranges' extent.  ``events`` reads the trace as ``trace.from_profiler``
does with that repaired: every device-side user annotation is dropped,
whatever its name, and host-side ``repro::`` ranges come as events of
kind 'span'.  No other event changes, so ``trace.summarize`` reads the
same numbers from it (it ignores the spans).

``report`` reduces the spans within the window (the ``perfbench::window``
range): for each name the ranges that overlap it, their summed host
seconds, their union (``span_s``) and the seconds of device idleness
inside that union (``span_idle_s``).  Nested names overlap; each counts
its own.
"""
from __future__ import annotations

import collections
import dataclasses

from perfbench.harness.trace import (DEVICE_KINDS, WINDOW, Event, _gaps,
                                     _runtime_call)

SPAN_PREFIX = "repro::"


def events(prof) -> list[Event]:
    """Events of a finished ``torch.profiler.profile``."""
    return from_kineto(prof.profiler.kineto_results.events())


def from_kineto(raw) -> list[Event]:
    """Events of kineto's raw results (anything with their accessors)."""
    from torch.autograd import DeviceType
    out = []
    for e in raw:
        name = e.name()
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue                # a host range's device-side copy
            kind = "memcpy" if name.startswith("Memcpy") else \
                "memset" if name.startswith("Memset") else "kernel"
            out.append(Event(name, kind, s, t, e.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            out.append(Event(name, "span", s, t))
        elif name.startswith("perfbench::"):
            out.append(Event(name, "range", s, t))
        elif _runtime_call(name):
            out.append(Event(name, "launch", s, t, e.correlation_id()))
        else:
            out.append(Event(name, "cpu", s, t))
    return out


@dataclasses.dataclass
class SpanReport:
    window_s: float
    busy_s: float
    count: dict          # span name -> ranges overlapping the window
    host_s: dict         # span name -> their summed seconds in the window
    span_s: dict         # span name -> seconds of their union
    span_idle_s: dict    # span name -> device-idle seconds in that union


def _merge(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def report(evs: list[Event]) -> SpanReport | None:
    """The spans of the window; None when the trace has no window."""
    wins = [e for e in evs if e.kind == "range" and e.name == WINDOW]
    if not wins:
        return None
    lo, hi = wins[0].start_us, wins[0].end_us
    busy = _merge((max(e.start_us, lo), min(e.end_us, hi)) for e in evs
                  if e.kind in DEVICE_KINDS and e.end_us > lo
                  and e.start_us < hi)
    gaps = _gaps(busy, lo, hi)
    by_name = collections.defaultdict(list)
    for e in evs:
        if e.kind == "span" and e.end_us > lo and e.start_us < hi:
            by_name[e.name].append((max(e.start_us, lo), min(e.end_us, hi)))
    count, host, union, idle = {}, {}, {}, {}
    for name, iv in sorted(by_name.items()):
        merged = _merge(iv)
        count[name] = len(iv)
        host[name] = sum(e - s for s, e in iv) / 1e6
        union[name] = sum(e - s for s, e in merged) / 1e6
        idle[name] = _overlap(merged, gaps) / 1e6
    return SpanReport((hi - lo) / 1e6, sum(e - s for s, e in busy) / 1e6,
                      count, host, union, idle)

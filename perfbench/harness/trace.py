"""Reduce a profiler trace to what the per-layer metrics read.

Events are plain tuples, so the reduction is tested without a card:

    Event(name, kind, start_us, end_us, corr)

``kind`` is 'kernel', 'memcpy' or 'memset' for device activity, 'launch'
for a host call into the CUDA runtime or its low-level API (``corr`` pairs it
with the device activity it started), 'range' for a harness annotation
(``perfbench::<op>``, ``perfbench::window``) and 'cpu' for any other host
op.  ``summarize`` keeps what lies in the window (the 'perfbench::window'
range) and gives the union of device-busy intervals, the idle share, the
device time of copies, of the kernels launched
inside each ``perfbench::op::<name>`` range, and the breakdown: the device
operations that took most time and the idle gaps by what the host was
doing meanwhile (the most specific host op that covers most of the gap).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import NamedTuple

WINDOW = "perfbench::window"
# host events of the profiler's own bookkeeping: they name no idle gap
PROFILER_EVENTS = ("Activity Buffer Request", "Activity Buffer Release")
OP_PREFIX = "perfbench::op::"
DEVICE_KINDS = ("kernel", "memcpy", "memset")


class Event(NamedTuple):
    name: str
    kind: str
    start_us: float
    end_us: float
    corr: int = -1


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    copy_s: float             # memcpy device seconds
    op_s: dict                # harness op range -> device seconds launched in it
    device_ops: list          # [[name, seconds]] top 10
    idle_gaps: list           # [[host activity, seconds]] top 10

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo, hi):
    """Idle (start, end) pairs between merged busy intervals in [lo, hi]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _name_gaps(gaps, host) -> list[str]:
    """For each idle gap, the most specific host op covering most of it:
    among the ops that overlap it by at least half the largest overlap,
    the shortest ('no host op' where none overlaps)."""
    starts = [g[0] for g in gaps]
    cands = [[] for _ in gaps]
    for name, s, e in host:
        j = max(bisect.bisect_right(starts, s) - 1, 0)
        while j < len(gaps) and gaps[j][0] < e:
            ov = min(e, gaps[j][1]) - max(s, gaps[j][0])
            if ov > 0:
                cands[j].append((ov, e - s, name))
            j += 1
    out = []
    for c in cands:
        if not c:
            out.append("no host op")
            continue
        top = max(x[0] for x in c)
        out.append(min((x for x in c if x[0] >= 0.5 * top),
                       key=lambda x: x[1])[2])
    return out


def summarize(events: list[Event], top: int = 10) -> Summary | None:
    """The window's summary; None when the trace has no window or no
    device activity in it."""
    wins = [e for e in events if e.kind == "range" and e.name == WINDOW]
    if not wins:
        return None
    lo, hi = wins[0].start_us, wins[0].end_us
    dev = [e for e in events if e.kind in DEVICE_KINDS
           and e.end_us > lo and e.start_us < hi]
    if not dev:
        return None
    clipped = [(max(e.start_us, lo), min(e.end_us, hi)) for e in dev]
    busy_us = _union(clipped)
    kernel_us = collections.Counter()
    copy_us = 0.0
    for e, (s, t) in zip(dev, clipped):
        if e.kind == "memcpy":
            copy_us += t - s
        kernel_us[e.name] += t - s
    # kernels launched inside each harness op range
    ranges = sorted((e.start_us, e.end_us, e.name[len(OP_PREFIX):])
                    for e in events
                    if e.kind == "range" and e.name.startswith(OP_PREFIX))
    starts = [r[0] for r in ranges]
    launch_at = {e.corr: e.start_us for e in events
                 if e.kind == "launch" and e.corr >= 0}
    op_us = collections.Counter()
    for e, (s, t) in zip(dev, clipped):
        at = launch_at.get(e.corr)
        if at is None:
            continue
        j = bisect.bisect_right(starts, at) - 1
        if j >= 0 and ranges[j][0] <= at <= ranges[j][1]:
            op_us[ranges[j][2]] += t - s
    host = [(e.name, e.start_us, e.end_us) for e in events
            if e.kind in ("cpu", "range", "launch") and e.name != WINDOW
            and e.name not in PROFILER_EVENTS and e.end_us > lo and e.start_us < hi]
    gaps = _gaps(clipped, lo, hi)
    idle = collections.Counter()
    for g, name in zip(gaps, _name_gaps(gaps, host)):
        idle[name] += g[1] - g[0]
    return Summary(
        window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
        copy_s=copy_us / 1e6, op_s={k: v / 1e6 for k, v in op_us.items()},
        device_ops=[[k, v / 1e6] for k, v in kernel_us.most_common(top)],
        idle_gaps=[[k, v / 1e6] for k, v in idle.most_common(top)])


def _runtime_call(name: str) -> bool:
    """A CUDA runtime (cudaLaunchKernel) or low-level API (cuLaunchKernel)
    call."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def from_profiler(prof) -> list[Event]:
    """Events of a finished ``torch.profiler.profile``, from its raw
    kineto results (no per-event Python tree is built)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("perfbench::"):
                continue                # the ranges' device-side copies
            kind = "memcpy" if name.startswith("Memcpy") else \
                "memset" if name.startswith("Memset") else "kernel"
            out.append(Event(name, kind, s, t, e.correlation_id()))
        elif name.startswith("perfbench::"):
            out.append(Event(name, "range", s, t))
        elif _runtime_call(name):
            out.append(Event(name, "launch", s, t, e.correlation_id()))
        else:
            out.append(Event(name, "cpu", s, t))
    return out

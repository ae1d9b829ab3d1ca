"""The port's own spans and host-wait counter, on the profiler's clock.

One switch, ``enable(on)``, off by default.

* ``span(name)`` — off, it returns one shared no-op context: one flag
  test, no ``record_function``.  On, it adds its host-clock duration to
  ``name``'s total and count, and while a profiler records it enters
  ``torch.profiler.record_function("repro::" + name)``, so the range lies
  in the kineto trace beside the device's kernels and copies.  Without a
  profiler a range records nothing, and entering one costs ~12 us a
  span (against ~1 us for the rest), which a serving batch of ~1 ms
  feels.
* ``host_wait(what)`` — brackets each place where the program blocks the
  host on the device (a read of a device value, a stream synchronise,
  an upload from pageable memory, which torch ends with a synchronise).
  It always adds one to the ``host_waits`` counter; on, it is also the
  span ``host_wait::<what>``.  The blocking expression stays written
  inside the ``with`` at its call site, where the analysis lint sees it.
* ``snapshot()`` — ``{"spans": {name: (count, seconds)}, "counters":
  {"host_waits": n}}``; ``delta(before, after)`` is what happened
  between two snapshots.

Clock: a span's start and end are ``time.time_ns()``.  Kineto stamps its
host events on the same clock (CLOCK_REALTIME, ns since the epoch), so a
span's ``start_ns`` and its range's ``start_ns()`` in a trace compare
without conversion; the span's start is taken just after the range is
entered.

The totals are the process's: a reader takes a snapshot before and after
what it measures.
"""
from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "repro::"

_on = False
_totals: dict[str, list[int]] = {}      # name -> [count, ns]
_host_waits = 0
_OFF = contextlib.nullcontext()


def enable(on: bool) -> None:
    """Turn the spans on or off (the counter always counts)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        ns = time.time_ns() - self.start_ns
        if self._range is not None:
            self._range.__exit__(*exc)
        tot = _totals.get(self.name)
        if tot is None:
            _totals[self.name] = [1, ns]
        else:
            tot[0] += 1
            tot[1] += ns
        return False


def span(name: str):
    """A context over one phase of the program (see the module doc)."""
    if not _on:
        return _OFF
    return _Span(name)


def host_wait(what: str):
    """A context over one wait of the host on the device: counted always,
    the span ``host_wait::<what>`` when on."""
    global _host_waits
    _host_waits += 1
    if not _on:
        return _OFF
    return _Span("host_wait::" + what)


def host_waits() -> int:
    """The host waits counted so far in this process."""
    return _host_waits


def snapshot() -> dict:
    return {"spans": {n: (c, ns / 1e9) for n, (c, ns) in _totals.items()},
            "counters": {"host_waits": _host_waits}}


def delta(before: dict, after: dict) -> dict:
    """What ``after`` adds to ``before`` (two ``snapshot()``s): the spans
    entered between them and the counters' increase."""
    spans = {}
    for name, (c, s) in after["spans"].items():
        c0, s0 = before["spans"].get(name, (0, 0.0))
        if c > c0:
            spans[name] = (c - c0, s - s0)
    return {"spans": spans,
            "counters": {k: v - before["counters"].get(k, 0)
                         for k, v in after["counters"].items()}}

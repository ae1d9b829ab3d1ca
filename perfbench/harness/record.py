"""The harness's own spans and call counts around calls into the program.

``Spans`` wraps a callable and keeps (start, end) host-clock seconds of
every call, synchronising the device at the end of each when asked (the
traced run), so a span holds the device work its call started.

``OpRecorder`` wraps the operations of ``repro_torch.kernels.ops`` that
have a work count in ``rooflines/``: each call runs inside a
``perfbench::op::<name>`` profiler range (so the trace attributes its
kernels to it) and is counted under its work key.  It is on only in the
traced phase of a traced run, and restores the functions on exit.
"""
from __future__ import annotations

import contextlib
import time

from perfbench import rooflines
from perfbench.harness.trace import OP_PREFIX


class Spans:
    def __init__(self, sync=None):
        self.times: list[tuple[float, float]] = []
        self._sync = sync

    def wrap(self, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self._sync is not None:
                self._sync()
            self.times.append((t0, time.perf_counter()))
            return out
        return wrapped

    def within(self, lo: float, hi: float) -> list[tuple[float, float]]:
        return [(a, b) for a, b in self.times if a >= lo and b <= hi]


class OpRecorder:
    """Counts of each operation's calls by work key, with the payload
    its work count needs."""

    def __init__(self, names=None):
        self.names = rooflines.names() if names is None else list(names)
        self.calls: dict[str, dict] = {n: {} for n in self.names}
        self.totals: dict[str, tuple] = {}

    @contextlib.contextmanager
    def recording(self):
        import torch
        from repro_torch.kernels import ops
        saved = {}
        for name in self.names:
            mod = rooflines.module(name)
            fn = getattr(ops, mod.OP)
            saved[mod.OP] = fn
            setattr(ops, mod.OP, self._wrap(name, mod, fn, torch))
        try:
            yield self
        finally:
            for op, fn in saved.items():
                setattr(ops, op, fn)

    def _wrap(self, name, mod, fn, torch):
        calls = self.calls[name]
        label = OP_PREFIX + name

        def wrapped(*args, **kwargs):
            key, payload = mod.describe(*args, **kwargs)
            slot = calls.get(key)
            if slot is None:
                calls[key] = [1, payload]
            else:
                slot[0] += 1
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    def finish(self) -> None:
        """Work out each operation's (calls, flops, bytes, bound seconds)
        and drop the payloads (they hold the program's index tensors)."""
        from perfbench.rooflines.peaks import bound_s
        self.totals = {}
        for name in self.names:
            mod = rooflines.module(name)
            calls = flops = nbytes = bound = 0.0
            for count, payload in self.calls[name].values():
                f, b = mod.work(payload)
                calls += count
                flops += count * f
                nbytes += count * b
                bound += count * bound_s(f, b)
            self.totals[name] = (int(calls), flops, nbytes, bound)
        self.calls = {n: {} for n in self.names}


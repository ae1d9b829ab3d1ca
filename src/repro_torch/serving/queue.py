"""Request microbatcher — coalesces single-user queries into device-sized
batches (the port's copy of ``repro/serving/queue.py``, pure Python).

Serving traffic arrives one user at a time, but every layer below is
batch-shaped: the fused top-K kernel amortizes its catalogue sweep over
the user batch.  The queue closes that gap with the classic two-trigger
microbatch policy:

  dispatch when ``max_batch`` requests are waiting (occupancy bound)
  OR the oldest waiting request has aged ``max_wait_us`` (latency bound)

Time is injected (``Clock``): production uses ``WallClock``; tests use
``ManualClock``, which makes batch composition a pure function of the
(trace, clock) pair — the determinism contract pinned by
tests/test_torch_serving.py.

Dispatched batches are padded up a power-of-two *bucket ladder*
(1, 2, 4, …, max_batch), never to arbitrary occupancy, so the scorer
sees at most ``log2(max_batch)+1`` distinct batch shapes over any
trace, as in the reference.  Pad slots repeat user id 0 and are dropped
before responses are built, so padding changes shapes only, never
results.

Backpressure is bounded-depth: ``submit`` raises ``QueueFull`` beyond
``max_depth`` waiting requests instead of queueing unboundedly — the
caller sheds load where it can still answer cheaply.  Every request
carries its enqueue timestamp; the queue stamps wait time at dispatch
so the service layer can report steady-state wait/service/total
latency percentiles per request.
"""
from __future__ import annotations

import dataclasses
import time


class Clock:
    """Injectable microsecond clock (duck-typed: ``now_us() -> int``)."""

    def now_us(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError


class WallClock(Clock):
    """Monotonic wall time in microseconds."""

    def now_us(self) -> int:
        return time.monotonic_ns() // 1_000


class ManualClock(Clock):
    """Deterministic virtual time: advances only when told.  Makes queue
    behaviour (and the load bench's arrival process) a pure function of
    the request trace."""

    def __init__(self, start_us: int = 0):
        self._now = int(start_us)

    def now_us(self) -> int:
        return self._now

    def advance(self, dt_us: int) -> int:
        if dt_us < 0:
            raise ValueError(f"cannot advance time backwards ({dt_us}us)")
        self._now += int(dt_us)
        return self._now


class QueueFull(RuntimeError):
    """Bounded-depth backpressure: the queue sheds load instead of
    growing an unbounded backlog."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One pending single-user query."""
    req_id: int
    user_id: int
    t_submit_us: int


@dataclasses.dataclass(frozen=True)
class Batch:
    """One dispatched microbatch: ``user_ids`` is padded to ``bucket``
    slots (pad slots repeat user id 0); only the first
    ``len(requests)`` rows correspond to real requests."""
    requests: tuple[Request, ...]
    user_ids: tuple[int, ...]
    bucket: int
    t_dispatch_us: int

    @property
    def occupancy(self) -> float:
        return len(self.requests) / self.bucket

    @property
    def wait_us(self) -> tuple[int, ...]:
        return tuple(self.t_dispatch_us - r.t_submit_us for r in self.requests)


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch — the pad-to-
    bucket ladder that bounds distinct batch shapes."""
    if n < 1:
        raise ValueError(f"bucket_for needs n >= 1, got {n}")
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class RequestQueue:
    """FIFO microbatcher with max-batch/max-wait dispatch, pad-to-bucket
    shaping and bounded-depth backpressure."""

    def __init__(self, *, max_batch: int = 64, max_wait_us: int = 1_000,
                 max_depth: int | None = None, clock: Clock | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be >= 0, got {max_wait_us}")
        self.max_batch = int(max_batch)
        self.max_wait_us = int(max_wait_us)
        self.max_depth = int(max_depth) if max_depth is not None \
            else 16 * self.max_batch
        if self.max_depth < self.max_batch:
            raise ValueError(
                f"max_depth ({self.max_depth}) must be >= max_batch "
                f"({self.max_batch}) or full batches could never form")
        self.clock = clock or WallClock()
        self._pending: list[Request] = []
        self._next_id = 0
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_dispatched = 0
        self.n_batches = 0
        self._occupancy_sum = 0.0

    # ------------------------------------------------------------ intake
    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, user_id: int) -> int:
        """Enqueue one single-user query; returns its request id.
        Raises ``QueueFull`` past ``max_depth`` pending requests."""
        if len(self._pending) >= self.max_depth:
            self.n_rejected += 1
            raise QueueFull(
                f"queue depth {len(self._pending)} at max_depth "
                f"{self.max_depth}; shed load or drain faster")
        req = Request(self._next_id, int(user_id), self.clock.now_us())
        self._next_id += 1
        self.n_submitted += 1
        self._pending.append(req)
        return req.req_id

    # ------------------------------------------------------------ dispatch
    def ready(self) -> bool:
        """True when the two-trigger policy says dispatch now: a full
        batch is waiting, or the oldest request has hit its deadline."""
        if len(self._pending) >= self.max_batch:
            return True
        if not self._pending:
            return False
        age = self.clock.now_us() - self._pending[0].t_submit_us
        return age >= self.max_wait_us

    def next_deadline_us(self) -> int | None:
        """When the oldest pending request's wait bound expires (None if
        empty) — what an event loop would sleep until."""
        if not self._pending:
            return None
        return self._pending[0].t_submit_us + self.max_wait_us

    def next_batch(self, force: bool = False) -> Batch | None:
        """Pop one microbatch if ``ready()`` (or ``force`` and anything
        is pending): the oldest ``<= max_batch`` requests, FIFO, padded
        to their bucket."""
        if not self._pending or not (force or self.ready()):
            return None
        take = self._pending[:self.max_batch]
        self._pending = self._pending[len(take):]
        bucket = bucket_for(len(take), self.max_batch)
        ids = tuple(r.user_id for r in take) + (0,) * (bucket - len(take))
        batch = Batch(tuple(take), ids, bucket, self.clock.now_us())
        self.n_dispatched += len(take)
        self.n_batches += 1
        self._occupancy_sum += batch.occupancy
        return batch

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "depth": len(self._pending),
            "submitted": self.n_submitted,
            "rejected": self.n_rejected,
            "dispatched": self.n_dispatched,
            "batches": self.n_batches,
            "mean_occupancy": (self._occupancy_sum / self.n_batches
                               if self.n_batches else 0.0),
        }

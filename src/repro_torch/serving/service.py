"""RecommenderService — the serving facade: queue → Recommender (the port
of ``repro/serving/service.py``; the ANN stage comes with a later slice).

Single-user queries enter the ``RequestQueue`` (coalescing +
backpressure), dispatched microbatches run through the ``Recommender``,
and per-request responses come back with their latency decomposition
(wait in queue, batch service, total).  Callers ``submit`` then ``poll``;
under a ``ManualClock`` the service advances virtual time by each
batch's *measured* compute, so a trace replays deterministically while
still charging real compute per batch.  A batch's service time ends
when its results are on the host, so it includes the device's work.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.queue import Batch, ManualClock, RequestQueue

# re-exported for callers that catch backpressure at the service level
from repro_torch.serving.queue import QueueFull  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Response:
    """One completed request with its latency decomposition."""
    req_id: int
    user_id: int
    ids: np.ndarray            # i32[k] recommended item ids (-1 invalid)
    scores: np.ndarray         # f32[k] their scores (-inf invalid)
    wait_us: int               # time spent coalescing in the queue
    service_us: int            # the batch's compute, charged to each rider
    total_us: int              # wait + service


def _pct(vals, q: float) -> float:
    if not len(vals):
        return 0.0
    return float(np.percentile(np.asarray(vals), q))


class RecommenderService:
    """Queue-fronted serving over a ``Recommender`` snapshot."""

    def __init__(self, recommender, *, max_batch: int = 64,
                 max_wait_us: int = 1_000, max_depth: int | None = None,
                 clock=None, k: int | None = None):
        self.rec = recommender
        self.k = int(k) if k is not None else recommender.k
        self.clock = clock if clock is not None else ManualClock()
        self.queue = RequestQueue(max_batch=max_batch,
                                  max_wait_us=max_wait_us,
                                  max_depth=max_depth, clock=self.clock)
        self._wait_us: list[int] = []
        self._service_us: list[int] = []
        self._total_us: list[int] = []
        self.n_completed = 0

    # ------------------------------------------------------------ intake
    def submit(self, user_id: int) -> int:
        """Enqueue one user's query (raises ``QueueFull`` under
        backpressure); the answer arrives from a later ``poll``."""
        return self.queue.submit(user_id)

    # ------------------------------------------------------------ serving
    def _run_batch(self, batch: Batch) -> list[Response]:
        t0 = time.monotonic_ns()
        ids, scores = self.rec.recommend(
            np.asarray(batch.user_ids, np.int32), k=self.k)
        service_us = max((time.monotonic_ns() - t0) // 1_000, 1)
        # under virtual time the batch's measured compute *is* the time
        # that passes — arrivals during it see a busy server
        if isinstance(self.clock, ManualClock):
            self.clock.advance(service_us)
        out = []
        for row, req in enumerate(batch.requests):
            wait = batch.t_dispatch_us - req.t_submit_us
            total = wait + service_us
            self._wait_us.append(wait)
            self._service_us.append(service_us)
            self._total_us.append(total)
            self.n_completed += 1
            out.append(Response(req.req_id, req.user_id,
                                np.asarray(ids[row]),
                                np.asarray(scores[row]),
                                wait, service_us, total))
        return out

    def poll(self, force: bool = False) -> list[Response]:
        """Dispatch at most one microbatch if the queue says it's time
        (or ``force`` and anything is pending); returns its responses
        (empty list when nothing dispatched)."""
        batch = self.queue.next_batch(force=force)
        return self._run_batch(batch) if batch is not None else []

    def drain(self) -> list[Response]:
        """Flush everything pending regardless of deadlines."""
        out = []
        while len(self.queue):
            out.extend(self.poll(force=True))
        return out

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Queue + latency + cache counters for the whole service."""
        cache = self.rec.cache_stats() if hasattr(self.rec, "cache_stats") \
            else {}
        hit = {n: s["hit_rate"] for n, s in cache.items()}
        return {
            **self.queue.stats(),
            "completed": self.n_completed,
            "wait_p50_us": _pct(self._wait_us, 50),
            "wait_p99_us": _pct(self._wait_us, 99),
            "service_p50_us": _pct(self._service_us, 50),
            "service_p99_us": _pct(self._service_us, 99),
            "total_p50_us": _pct(self._total_us, 50),
            "total_p99_us": _pct(self._total_us, 99),
            "cache_hit_rate": hit,
        }

    def describe(self) -> str:
        q = self.queue
        return (f"RecommenderService[k={self.k} max_batch={q.max_batch} "
                f"max_wait={q.max_wait_us}us max_depth={q.max_depth}] "
                f"over {self.rec.describe()}")

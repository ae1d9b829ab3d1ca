"""The runner of every serving mix (``"kind": "serve"``): an open loop.

Set-up generates the graph, builds one ``Run`` through the Experiment API
and its ``Run.service(clock=WallClock())`` (the final embeddings of the
state as built, placed and snapshotted), then serves ``warm_seconds`` of
the mix's own traffic from another stream of the seed, so every batch
shape the window meets is warm.  The window serves a fresh
``RecommenderService`` over the same ``Recommender``, so its counters
hold the window alone.

Arrivals are a Poisson process at ``rate_per_s``; the user of each
request is the r-th most active user of the train graph (by degree, ties
by id), r drawn Zipf(``user_alpha``) over all users.  The loop submits every request when
it is due, polls the service, and times each from when it was due to
when its answer is on the host.  A request the queue refuses
(``QueueFull``) fails; requests still waiting when the window closes are
served on, up to ``drain_seconds``, and timed so; one never answered
fails and makes the run incorrect.  A traced run then serves
``trace_seconds`` more of the traffic under the profiler.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench import reference
from perfbench.harness import check, program, trace as tracing
from perfbench.harness.context import Context
from perfbench.harness.outcome import Outcome, log
from perfbench.harness.record import OpRecorder
from perfbench.reference import graph as ref_graph
from perfbench.reference import topk as ref_topk

SPIN_S = 5e-4          # sleep at most this long while idle


def arrivals(mix: dict, seconds: float, popular: np.ndarray, seed: int,
             stream: int) -> tuple[np.ndarray, np.ndarray]:
    """(due seconds, user ids) of the requests due in [0, seconds)."""
    rng = np.random.default_rng((seed, stream))
    rate = float(mix["rate_per_s"])
    due = np.cumsum(rng.exponential(1.0 / rate, int(rate * seconds * 1.2
                                                       + 64)))
    due = due[due < seconds]
    n = len(popular)
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64)
                    ** -float(mix["user_alpha"]))
    ranks = np.searchsorted(cdf / cdf[-1], rng.random(len(due)),
                            side="right").clip(max=n - 1)
    return due, popular[ranks]


@dataclasses.dataclass
class Served:
    """Per request of a schedule: latency (s, NaN unanswered), what the
    answer says (its user, ids, scores), refused, how late the generator
    submitted it; and when the last answer came (s from the start).
    Answers are copied into arrays as they come, so the loop keeps few
    live objects (a list of responses would make each garbage
    collection walk all of them, in the window)."""
    lat: np.ndarray
    user: np.ndarray
    ids: np.ndarray
    scores: np.ndarray
    refused: np.ndarray
    late: np.ndarray
    last: float = 0.0

    @property
    def answered(self) -> np.ndarray:
        return ~np.isnan(self.lat)


def open_loop(svc, due: np.ndarray, users: np.ndarray,
              drain_s: float) -> Served:
    """Serve the schedule: submit each request when due, poll, and sleep
    (at most ``SPIN_S``) only while nothing is due or ready."""
    from repro_torch.serving import QueueFull
    n, k = len(due), int(svc.k)
    out = Served(np.full(n, np.nan), np.full(n, -1, np.int64),
                 np.full((n, k), -1, np.int64),
                 np.full((n, k), np.nan, np.float32), np.zeros(n, bool),
                 np.zeros(n))
    sent = {}
    i = 0
    stop = (due[-1] if n else 0.0) + drain_s
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < n and due[i] <= now:
            out.late[i] = now - due[i]
            try:
                sent[svc.submit(int(users[i]))] = i
            except QueueFull:
                out.refused[i] = True
            i += 1
        got = svc.poll()
        if got:
            out.last = time.perf_counter() - t0
            for r in got:
                j = sent.pop(r.req_id)
                out.lat[j] = out.last - due[j]
                out.user[j] = r.user_id
                out.ids[j] = r.ids
                out.scores[j] = r.scores
            continue
        if (i >= n and not sent) or now > stop:
            break
        nxt = due[i] - now if i < n else SPIN_S
        deadline = svc.queue.next_deadline_us()
        if deadline is not None:
            nxt = min(nxt, (deadline - svc.clock.now_us()) / 1e6)
        if nxt > 0:
            time.sleep(min(nxt, SPIN_S))
    return out


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Outcome:
    """One run of the cell; ``t_start`` is the process's start on the
    ``time.perf_counter`` clock (``setup_s`` counts from it)."""
    from repro_torch.serving import RecommenderService
    from repro_torch.serving.queue import WallClock
    cfg, mix = cell.config, cell.mix
    inputs = program.make_inputs(cfg, seed, device)
    r = program.build_run(cfg, mix, seed, inputs, device)
    svc0 = r.service(clock=WallClock())
    rec = svc0.rec
    deg = np.bincount(inputs.train_user, minlength=inputs.n_users)
    popular = np.lexsort((np.arange(inputs.n_users), -deg))
    due, users = arrivals(mix, mix["warm_seconds"], popular, seed, 1)
    open_loop(svc0, due, users, mix["drain_seconds"])
    serve = r.spec.serve

    def service():
        return RecommenderService(rec, max_batch=serve.queue_max_batch,
                                  max_wait_us=serve.queue_max_wait_us,
                                  clock=WallClock())

    program.sync(device)
    setup_s = time.perf_counter() - t_start

    due, users = arrivals(mix, seconds, popular, seed, 2)
    svc = service()
    gc.collect()
    got = open_loop(svc, due, users, mix["drain_seconds"])
    answered = got.answered
    stats = svc.stats()
    log(requests=len(due), answered=int(answered.sum()),
        refused=int(got.refused.sum()), late_p50_ms=_ms(got.late, 50),
        late_p99_ms=_ms(got.late, 99), late_max_ms=_ms(got.late, 100),
        last_answer_s=got.last)

    summary, ops, n_traced = None, None, 0
    if traced:
        summary, ops, n_traced = _traced_phase(service(), mix, popular, seed,
                                               device)
    peak = program.peak_bytes(device)
    n_items, dim = int(rec.n_items), int(rec.item_e.shape[1])
    ok_lat = got.lat[answered]
    p99_ms = float(np.percentile(ok_lat, 99) * 1e3)
    ctx = Context(cell, max(got.last, seconds), int(answered.sum()), [],
                  {"service": stats}, summary,
                  n_traced, ops,
                  2.0 * n_items * dim * int(answered.sum()))
    k = int(svc.k)
    del r, svc0, svc, rec
    program.free(device)

    t_ref = time.perf_counter()
    ue, ie, indptr, items = reference_embeddings(cfg, inputs, seed, device)
    a_idx = np.nonzero(answered)[0]
    numbers = check.serve_numbers(ue, ie, indptr, items,
                                  users[a_idx].astype(np.int64),
                                  got.user[a_idx], got.ids[a_idx],
                                  got.scores[a_idx], k)
    program.sync(device)
    unanswered = int((~answered & ~got.refused).sum())
    numbers["unanswered"] = float(unanswered)
    correct, checks = check.judge(numbers, cell.limits)
    return Outcome(
        correct=correct, attempted=len(due),
        failed=int(got.refused.sum()) + unanswered,
        end_to_end={"setup_s": setup_s,
                    "serve_p50_ms": float(np.percentile(ok_lat, 50) * 1e3),
                    "serve_p99_ms": p99_ms},
        context=ctx, memory_peak_bytes=peak, checks=checks,
        info={"requests": len(due), "compared": len(a_idx),
              "serve_p99_ms": p99_ms, "late_p99_ms": _ms(got.late, 99),
              "reference_s": time.perf_counter() - t_ref})


def _ms(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q) * 1e3) if len(x) else 0.0


def reference_embeddings(cfg: dict, inputs, seed: int, device):
    """The reference's final embeddings of the seeded init and its
    user-CSR of seen items, from the generator's train edges."""
    tu = torch.from_numpy(inputs.train_user).to(device)
    ti = torch.from_numpy(inputs.train_item).to(device)
    rg = ref_graph.Graph(tu, ti, inputs.n_users, inputs.n_items)
    arch = reference.model(cfg["arch"])
    params = arch.init(seed, inputs.n_users, inputs.n_items, cfg["embed_dim"],
                       cfg["n_layers"], device)
    with torch.no_grad(), reference.precision("float32"):
        ue, ie = arch.forward(params, rg, cfg["n_layers"])
    indptr, items = ref_topk.user_csr(tu, ti, inputs.n_users)
    return ue, ie, indptr, items


def _traced_phase(svc, mix, popular, seed, device):
    from torch.profiler import ProfilerActivity, profile
    ops = OpRecorder()
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    due, users = arrivals(mix, mix["trace_seconds"], popular, seed, 3)
    with ops.recording(), profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            got = open_loop(svc, due, users, mix["drain_seconds"])
            program.sync(device)
    ops.finish()
    return (tracing.summarize(tracing.from_profiler(prof)), ops,
            int(got.answered.sum()))

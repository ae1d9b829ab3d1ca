"""The port's spans and host-wait counter (``repro_torch.trace``).

Off, a span is one shared no-op context and records nothing, while the
counter still counts; on, spans are ``repro::`` profiler ranges with
per-name totals.  A training step and a serving batch count the host
waits they make.  The ``cuda`` tests put a span and its kineto range on
one clock on the card, show that the benchmark's span reader turns no
program range into device activity, count a step's waits with its
tables on the card and in pinned host memory (a step waits on its loss
alone, whether the step before staged its batch or it stages its own),
and hold the counter to the card's own account: every synchronising call
of a step, with its batch staged or not, or of a serving batch lies
inside a ``host_wait``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace.py
"""
import pathlib
import time

import numpy as np
import pytest
import torch

from repro_torch.data import synth
from repro_torch.eval import Recommender
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.pipeline.sparse import BipartiteCSR
from repro_torch import trace
from repro_torch.serving import ManualClock, RecommenderService

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def traced():
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)


def _counts(d) -> dict:
    return {name: c for name, (c, _) in d["spans"].items()}


def _pipe(arch, device="cpu", **kw):
    """A tiny run: two 64-row microbatches a step."""
    data = synth.generate_bipartite(40, 30, 400, seed=0)
    cfg = PipelineConfig(arch=arch, embed_dim=8, n_layers=1, base_batch=64,
                         target_batch=128, microbatch=64, warmup_epochs=0,
                         **kw)
    return build_pipeline(cfg, data, device=device)


def _steps(pipe, n):
    state = pipe.init_state()
    before = trace.snapshot()
    for step in range(n):
        state, _ = pipe.step_fn(state, step)
    return trace.delta(before, trace.snapshot())


def test_off_enters_no_range_and_keeps_no_totals_but_counts(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")       # one shared no-op
    before = trace.snapshot()
    with trace.span("a"):
        with trace.host_wait("read"):
            pass
    assert trace.delta(before, trace.snapshot()) == \
        {"spans": {}, "counters": {"host_waits": 1}}


def test_on_gives_nested_totals_and_counts(traced, monkeypatch):
    """Without a profiler recording, no range is entered either."""
    def entered(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    before = trace.snapshot()
    for _ in range(3):
        with trace.span("outer"):
            with trace.span("inner"):
                time.sleep(0.002)
            with trace.host_wait("read"):
                pass
    d = trace.delta(before, trace.snapshot())
    assert _counts(d) == {"outer": 3, "inner": 3, "host_wait::read": 3}
    assert d["counters"] == {"host_waits": 3}
    assert 0.006 <= d["spans"]["inner"][1] <= d["spans"]["outer"][1]


def test_names_lie_in_a_cpu_profiler_trace_on_its_clock(traced):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step::forward") as s:
            torch.ones(64).sum()
        with trace.host_wait("loss"):
            float(torch.ones(()))
    got = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert {"repro::step::forward", "repro::host_wait::loss"} <= set(got)
    e = got["repro::step::forward"]
    # the span's start is taken just inside its range
    assert -20_000 <= s.start_ns - e.start_ns() <= e.duration_ns()


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("arch", ["lightgcn", "ngcf", "dgcf"])
def test_training_step_counts_its_host_waits(arch, on):
    """One wait a step on the CPU (the loss read); the spans of each
    phase, ``step::stage`` once a step for the next step and once more in
    the first, which finds no batch staged and stages its own inside
    ``step::batch``, and the first epoch's hand-over, drawn inline.  DGCF
    adds, per forward of its one layer, a ``dgcf::route`` for each of its
    2 routing iterations and one ``dgcf::agree`` between them."""
    pipe = _pipe(arch)
    trace.enable(on)
    try:
        d = _steps(pipe, 2)
    finally:
        trace.enable(False)
    assert d["counters"]["host_waits"] == 2
    want = {"step::batch": 1, "step::stage": 3, "step::fetch": 2,
            "step::forward": 4, "step::backward": 4, "step::update": 2,
            "step::commit": 2, "host_wait::loss": 2,
            "step::perm": 1, "step::perm_draw": 1}
    if arch == "dgcf":
        want.update({"dgcf::route": 8, "dgcf::agree": 4})
    assert _counts(d) == (want if on else {})


def test_demoted_tables_on_the_host_add_no_wait():
    """Demoted leaves whose store is the device itself copy nothing, so
    ``commit`` does not wait (on the card it does: the cuda test)."""
    pipe = _pipe("lightgcn", memory_pins={"item_embed": "slow"},
                 memory_topology="uniform")
    assert pipe.n_offloaded > 0
    assert _steps(pipe, 2)["counters"]["host_waits"] == 2


def test_csr_build_is_one_setup_span(traced):
    before = trace.snapshot()
    g = BipartiteCSR(np.array([0, 1, 1]), np.array([1, 0, 2]), 2, 3,
                     device="cpu")
    assert g.n_edges == 3
    assert _counts(trace.delta(before, trace.snapshot())) == \
        {"setup::csr": 1}


@pytest.mark.parametrize("on", [False, True])
def test_serving_batch_counts_its_host_waits(on):
    """Three waits a batch on the CPU (the seen lists' width, the scores
    and ids to the host; the ids are not uploaded), in the service's own
    counter too."""
    rng = np.random.default_rng(0)
    ue = rng.standard_normal((30, 8)).astype(np.float32)
    ie = rng.standard_normal((50, 8)).astype(np.float32)
    user = np.sort(rng.integers(0, 30, 90))
    indptr = np.searchsorted(user, np.arange(31)).astype(np.int64)
    items = rng.integers(0, 50, 90).astype(np.int64)
    rec = Recommender(ue, ie, seen_indptr=indptr, seen_items=items, k=5,
                      user_batch=8, device="cpu")
    svc = RecommenderService(rec, max_batch=4, max_wait_us=200,
                             clock=ManualClock())
    trace.enable(on)
    try:
        before = trace.snapshot()
        for u in range(9):
            svc.submit(u)
        assert len(svc.drain()) == 9
        d = trace.delta(before, trace.snapshot())
    finally:
        trace.enable(False)
    s = svc.stats()
    assert s["batches"] == 3
    assert s["host_waits"] == d["counters"]["host_waits"] == 9
    assert "wait_p50_us" not in s
    want = {"serve::batch": 3, "serve::seen": 3, "host_wait::seen_width": 3,
            "host_wait::scores": 3, "host_wait::ids": 3}
    assert _counts(d) == (want if on else {})


def test_disabled_span_costs_under_a_microsecond():
    assert not trace.enabled()
    n, best = 100_000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("step::forward"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_span_and_its_kineto_range_share_one_clock_on_the_card(
        card, traced, monkeypatch):
    """Each span's host-clock start lies within 50 us of its range's in
    kineto's trace (after three spans that warm the profiler's path: the
    first range's entry alone can take longer); kineto copies the ranges
    onto the device timeline, and the benchmark's span reader returns
    none of them as device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.syspath_prepend(str(ROOT))
    from perfbench.harness import spans
    from perfbench.harness.trace import DEVICE_KINDS
    x = torch.ones(1 << 20, device=card)
    starts = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            with trace.span(f"clock::{i}") as s:
                (x * 2).sum()
            starts[f"repro::clock::{i}"] = s.start_ns
        torch.cuda.synchronize()
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.name() in starts]
    host = {e.name(): e.start_ns() for e in raw
            if e.device_type() != DeviceType.CUDA}
    assert set(host) == set(starts)
    gaps_us = [(starts[n] - host[n]) / 1e3 for n in sorted(starts)]
    assert max(abs(g) for g in gaps_us[3:]) < 50, gaps_us
    assert any(e.device_type() == DeviceType.CUDA and e.is_user_annotation()
               for e in raw)
    evs = spans.events(prof)
    assert not [e for e in evs
                if e.name.startswith("repro::") and e.kind in DEVICE_KINDS]
    assert sorted(e.name for e in evs if e.kind == "span") == sorted(starts)


# on the card a step waits once with its tables on the card, the loss
# read, whether the step before staged its batch or it stages its own
# (from a slot whose last copy has run: that wait is the loss read's)
_CARD_STEP_WAITS = 1


@pytest.mark.cuda
@pytest.mark.parametrize("pins,waits", [(None, _CARD_STEP_WAITS),
                                        ({"_embed": "host"},
                                         _CARD_STEP_WAITS + 1)])
def test_training_step_counts_its_host_waits_on_the_card(card, pins, waits):
    """The first step finds no batch staged and stages its own; it and
    the two steps after it, which take staged batches, each wait on the
    loss read with the tables on the card, and once more (``commit``'s
    copies landing) with them in host memory."""
    pipe = _pipe("lightgcn", device=card, memory_topology="h100-hbm-host",
                 memory_pins=pins)
    assert (pipe.n_offloaded > 0) == (pins is not None)
    assert _steps(pipe, 3)["counters"]["host_waits"] == 3 * waits


class _Witness:
    """The card's own account of the host's waits: under
    ``torch.cuda.set_sync_debug_mode("warn")`` every synchronising call
    warns as it returns, inside the ``with`` of its call site; each is
    filed as inside or outside an open ``host_wait``."""

    def __init__(self, monkeypatch):
        self.open, self.inside, self.outside = [], [], []
        witness = self

        class Span(trace._Span):
            __slots__ = ()

            def __enter__(self):
                if self.name.startswith("host_wait::"):
                    witness.open.append(self.name)
                return super().__enter__()

            def __exit__(self, *exc):
                if self.name.startswith("host_wait::"):
                    witness.open.pop()
                return super().__exit__(*exc)

        monkeypatch.setattr(trace, "_Span", Span)

    def run(self, fn):
        import traceback
        import warnings

        def show(message, *args, **kw):
            if "synchronizing cuda operation" not in str(message).lower():
                return
            if self.open:
                self.inside.append(self.open[-1])
            else:
                self.outside.append("".join(traceback.format_stack(limit=6)))

        torch.cuda.synchronize()
        trace.enable(True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    before = trace.snapshot()
                    fn()
                    return trace.delta(before, trace.snapshot())
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            trace.enable(False)


def _witness_step(card, monkeypatch, arch, pins, step):
    """The counts of ``step`` after step 0 (which builds the kernels and
    stages step 1), under the witness; no synchronising call outside a
    ``host_wait``, each inside one the counts hold.  The step stages the
    next step's batch, and its own first unless step 0 staged it."""
    pipe = _pipe(arch, device=card, memory_topology="h100-hbm-host",
                 memory_pins=pins)
    state = pipe.init_state()
    state, _ = pipe.step_fn(state, 0)
    witness = _Witness(monkeypatch)
    d = witness.run(lambda: pipe.step_fn(state, step))
    assert not witness.outside, witness.outside
    waits = {n for n in _counts(d) if n.startswith("host_wait::")}
    assert set(witness.inside) <= waits
    assert _counts(d)["step::stage"] == (1 if step == 1 else 2)
    landed = {"host_wait::landed"} if pins is not None else set()
    return d, waits - landed


_WITNESSED = [("lightgcn", None), ("ngcf", None), ("dgcf", None),
              ("lightgcn", {"_embed": "host"})]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,pins", _WITNESSED)
def test_every_wait_of_a_step_on_the_card_is_counted(card, monkeypatch,
                                                     arch, pins):
    """Every synchronising call a step makes on the card lies inside a
    ``host_wait``, and the counter holds each.  Step 1, whose batch step
    0 staged, counts only the loss read (and ``commit``'s landing with
    host tables) while it stages step 2."""
    d, waits = _witness_step(card, monkeypatch, arch, pins, 1)
    assert d["counters"]["host_waits"] == 1 + (pins is not None)
    assert waits == {"host_wait::loss"}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,pins", _WITNESSED)
def test_every_wait_of_an_inline_step_on_the_card_is_counted(
        card, monkeypatch, arch, pins):
    """Step 3 after step 0 finds no batch staged for it and stages its
    own inside ``step::batch``: every synchronising call lies inside a
    ``host_wait``, and it counts the loss read (and ``commit``'s landing
    with host tables) alone: both slots' last copies ran before step 0's
    loss read, so staging waits on neither."""
    d, waits = _witness_step(card, monkeypatch, arch, pins, 3)
    assert _counts(d)["step::batch"] == 1
    assert d["counters"]["host_waits"] == \
        _CARD_STEP_WAITS + (pins is not None)
    assert waits == {"host_wait::loss"}


@pytest.mark.cuda
def test_every_wait_of_a_serving_batch_on_the_card_is_counted(card,
                                                             monkeypatch):
    """A serving batch on the card waits four times (the users' upload,
    the seen lists' width, the scores and ids to the host), each inside
    a ``host_wait``; the service's counter holds them."""
    rng = np.random.default_rng(0)
    ue = rng.standard_normal((30, 8)).astype(np.float32)
    ie = rng.standard_normal((50, 8)).astype(np.float32)
    user = np.sort(rng.integers(0, 30, 90))
    indptr = np.searchsorted(user, np.arange(31)).astype(np.int64)
    items = rng.integers(0, 50, 90).astype(np.int64)
    rec = Recommender(ue, ie, seen_indptr=indptr, seen_items=items, k=5,
                      user_batch=8, device=card)
    svc = RecommenderService(rec, max_batch=4, max_wait_us=200,
                             clock=ManualClock())
    for u in range(4):
        svc.submit(u)
    assert len(svc.drain()) == 4                 # builds the kernels
    witness = _Witness(monkeypatch)

    def batch():
        for u in range(4):
            svc.submit(u)
        assert len(svc.drain()) == 4

    d = witness.run(batch)
    assert not witness.outside, witness.outside
    assert d["counters"]["host_waits"] == 4
    assert svc.stats()["host_waits"] == 8
    assert _counts(d)["serve::batch"] == 1

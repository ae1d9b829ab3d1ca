"""The next epoch's permutation drawn one epoch ahead (``data/loader.py``).

When the loader hands over epoch e's permutation it starts drawing
e+1's on a thread, and takes it at the next hand-over.  These tests hold
its batches to the inline draw's, ``default_rng((seed, epoch))
.permutation(n)[shard_id::num_shards]`` (``_inline_batches``), bit for
bit: across epoch crossings at 1, 2 and 3 shards, after ``seek()`` and
``load_state_dict()`` into the current, the next and a distant epoch,
with a pending draw of another seed, shard or edge count, and from many
threads at once.  They count the spans ``step::perm`` (a hand-over) and
``step::perm_draw`` (a miss), hold a loader to one draw at a time, and
a failed draw's error to its hand-over.
"""
import contextlib
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch import trace
from repro_torch.data import loader as loader_mod
from repro_torch.data import synth
from repro_torch.data.loader import EdgeLoader, LoaderState
from repro_torch.pipeline import PipelineConfig, build_pipeline
from torch_threads import one_torch_thread  # noqa: F401

SEED, BATCH = 7, 32


def _edges(n=1001):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 90, n).astype(np.int32),
            rng.integers(0, 70, n).astype(np.int32))


def _inline_batches(user, item, batch, seed, shard_id, num_shards, state,
                    count):
    """``count`` batches from ``state`` (drop_last), each epoch's
    permutation drawn inline."""
    n = len(range(shard_id, len(user), num_shards))
    spe = n // batch
    epoch, step = state.epoch, state.step
    for _ in range(count):
        if step >= spe:
            epoch, step = epoch + 1, 0
        perm = np.random.default_rng((seed, epoch)).permutation(len(user))
        idx = perm[shard_id::num_shards][step * batch:(step + 1) * batch]
        yield user[idx], item[idx]
        step += 1


def _assert_batches(loader, count):
    """The loader's next ``count`` batches equal the inline draw's."""
    want = _inline_batches(loader.user, loader.item, loader.batch,
                           loader.seed, loader.shard_id, loader.num_shards,
                           loader.state, count)
    for (wu, wi) in want:
        gu, gi = next(loader)
        assert gu.tobytes() == wu.tobytes() and gi.tobytes() == wi.tobytes()


@contextlib.contextmanager
def _perm_spans():
    """The spans on for the block; yields a dict that holds, after it,
    the counts of ``step::perm`` and ``step::perm_draw`` entered."""
    out = {}
    trace.enable(True)
    before = trace.snapshot()
    try:
        yield out
    finally:
        d = trace.delta(before, trace.snapshot())
        trace.enable(False)
        for name in ("step::perm", "step::perm_draw"):
            out[name] = d["spans"].get(name, (0, 0.0))[0]


@pytest.mark.parametrize("shard_id,num_shards", [(0, 1), (1, 2), (2, 3)])
def test_batches_equal_the_inline_draw_across_epochs(shard_id, num_shards):
    """Four epoch crossings: every batch the inline draw's bytes; five
    hand-overs, the first drawn inline and the four after it taken from
    the draw ahead."""
    user, item = _edges()
    a = EdgeLoader(user, item, batch=BATCH, seed=SEED, shard_id=shard_id,
                   num_shards=num_shards)
    with _perm_spans() as n:
        _assert_batches(a, 4 * a.steps_per_epoch() + 2)
    assert a.state == LoaderState(4, 2)
    assert n == {"step::perm": 5, "step::perm_draw": 1}
    assert a._ahead.key == (SEED, 5, len(user), shard_id, num_shards)


def _pipe():
    """400 edges, 64-row microbatches, two a step: 3 steps an epoch."""
    data = synth.generate_bipartite(40, 30, 400, seed=0)
    cfg = PipelineConfig(arch="lightgcn", embed_dim=8, n_layers=1,
                         base_batch=64, target_batch=128, microbatch=64,
                         warmup_epochs=0, seed=3)
    return build_pipeline(cfg, data, device="cpu")


def _bare_loader():
    """A loader 1.5 epochs in (31 batches an epoch): epoch 2's draw is
    pending."""
    user, item = _edges()
    a = EdgeLoader(user, item, batch=BATCH, seed=SEED)
    _assert_batches(a, 46)
    return a


def _seeked_pipe():
    """A pipeline after 4 steps (8 of 6-a-epoch microbatches): epoch 2's
    draw is pending."""
    pipe = _pipe()
    state = pipe.init_state()
    for s in range(4):
        state, _ = pipe.step_fn(state, s)
    return pipe.loader, pipe.seek


# where: the bare loader's state, then the pipeline's step and the epoch
# it seeks into: the current epoch (1), the next (2) and a distant one
WHERE = {"current": (LoaderState(1, 3), 4, 1),
         "next": (LoaderState(2, 1), 7, 2),
         "distant": (LoaderState(7, 0), 20, 6)}


@pytest.mark.parametrize("where", sorted(WHERE))
@pytest.mark.parametrize("how", ["load_state_dict", "seek"])
def test_seek_and_resume_take_the_draw_only_for_its_epoch(how, where):
    """After a ``load_state_dict()`` or ``seek()``, the rest of the epoch
    and one batch of the next are the inline draw's bytes.  Into the
    current epoch nothing is drawn until the crossing, into the next the
    pending draw is taken, and into a distant one the pending draw
    (epoch 2's) is dropped and the epoch drawn inline."""
    state, step, pipe_epoch = WHERE[where]
    if how == "load_state_dict":
        loader = _bare_loader()
        loader.load_state_dict({"epoch": state.epoch, "step": state.step})
        epoch = state.epoch
    else:
        loader, seek = _seeked_pipe()
        seek(step)
        epoch = pipe_epoch
    assert loader._ahead.key[1] == 2
    assert loader.state.epoch == epoch
    left = loader.steps_per_epoch() - loader.state.step
    assert left > 0
    with _perm_spans() as n:
        _assert_batches(loader, left + 1)
    assert n == {"step::perm": 1 + (where != "current"),
                 "step::perm_draw": int(where == "distant")}
    assert loader.state == LoaderState(epoch + 1, 1)
    assert loader._ahead.key[1] == epoch + 2


@pytest.mark.parametrize("attr,value", [("seed", SEED + 1), ("shard_id", 1),
                                        ("num_shards", 2), ("n_edges", 900)])
def test_a_draw_for_another_loader_is_never_taken(attr, value):
    """A pending draw handed to a loader of another seed, shard or edge
    count is dropped: that loader draws its own epoch inline (its bytes)."""
    user, item = _edges()
    a = EdgeLoader(user, item, batch=BATCH, seed=SEED)
    next(a)                                      # epoch 1's draw pending
    kw = dict(batch=BATCH, seed=SEED, shard_id=0, num_shards=1)
    if attr == "n_edges":
        user, item = user[:value], item[:value]
    else:
        kw[attr] = value
    if attr == "shard_id":
        kw["num_shards"] = 2
    b = EdgeLoader(user, item, **kw)
    b.load_state_dict({"epoch": 1, "step": 0})
    b._ahead = a._ahead                          # handed a's draw
    assert b._ahead.key[1] == 1 and b._ahead.key != b._key(1)
    with _perm_spans() as n:
        _assert_batches(b, 2)
    assert n == {"step::perm": 1, "step::perm_draw": 1}


# before the counted steps: nothing, or steps 0 and 1; then the first
# counted step, 0 or 7, which seeks into epoch 2 while epoch 1's draw is
# pending (dropped: epoch 2 is drawn inline)
_STARTS = {"from_step_0": ([], 0), "after_a_seek": ([0, 1], 7)}


@pytest.mark.parametrize("start", sorted(_STARTS))
def test_a_run_counts_its_hand_overs_and_misses(start):
    """Over 12 steps of a pipeline (3 an epoch) and the step staged after
    them, every epoch begun is one ``step::perm`` and only the first a
    ``step::perm_draw``: the hit share 1 - misses / hand-overs is 4/5."""
    before_steps, first = _STARTS[start]
    pipe = _pipe()
    state = pipe.init_state()
    for s in before_steps:
        state, _ = pipe.step_fn(state, s)
    with _perm_spans() as n:
        for s in range(first, first + 12):
            state, _ = pipe.step_fn(state, s)
    begun = pipe.loader.state.epoch + 1 - first // 3
    assert begun == 5
    assert n == {"step::perm": begun, "step::perm_draw": 1}
    assert 1 - n["step::perm_draw"] / n["step::perm"] == pytest.approx(0.8)


def test_one_draw_at_a_time(monkeypatch):
    """With each draw slowed, a loader that crosses epochs and is moved
    to distant ones holds one pending draw and never has two drawing:
    a stale draw is waited for before the next starts."""
    lock = threading.Lock()
    live, peak = [0], [0]

    class Slow(loader_mod._Ahead):
        def __init__(self, key):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            super().__init__(key)

        def _run(self):
            try:
                time.sleep(0.02)
                super()._run()
            finally:
                with lock:
                    live[0] -= 1

    monkeypatch.setattr(loader_mod, "_Ahead", Slow)
    user, item = _edges(301)
    a = EdgeLoader(user, item, batch=BATCH, seed=SEED)
    spe = a.steps_per_epoch()
    for epoch in (0, 5, 6, 11, 3):
        a.load_state_dict({"epoch": epoch, "step": spe - 1})
        _assert_batches(a, 2)                    # one crossing each
        assert isinstance(a._ahead, Slow)
    a._ahead.take()
    assert peak[0] == 1 and live[0] == 0


def test_many_loaders_on_many_threads():
    """Stress: 16 threads (more than the cores), each its own loader and
    so its own draw thread, each over six epochs with the interpreter
    switching threads every microsecond: every batch the inline draw's."""
    user, item = _edges(301)
    errors = []

    def work(seed):
        try:
            a = EdgeLoader(user, item, batch=BATCH, seed=seed)
            _assert_batches(a, 6 * a.steps_per_epoch())
        except BaseException as e:          # reported below
            errors.append(e)
            raise

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_a_draw_that_raised_raises_at_its_hand_over(monkeypatch):
    """A draw that fails on its thread raises its error where the loader
    takes it, on the caller's thread, and not before."""
    draw = loader_mod._draw

    def failing(seed, epoch, *rest):
        if epoch == 1:
            raise MemoryError("epoch 1")
        return draw(seed, epoch, *rest)

    monkeypatch.setattr(loader_mod, "_draw", failing)
    user, item = _edges()
    a = EdgeLoader(user, item, batch=BATCH, seed=SEED)
    _assert_batches(a, a.steps_per_epoch())      # epoch 0 whole
    with pytest.raises(MemoryError, match="epoch 1"):
        next(a)

"""One-step-ahead staging of the training step's target batch
(``Pipeline._stage``).

Each step, on every device and route, builds the next step's batch once
its own work is enqueued and starts its copy from a host slot (pinned on
the card) while the card runs; a step with no batch staged for it stages
its own first.  The CPU tests hold a run to an oracle that stages
nothing: a fresh pipeline that, at each step, seeks the loader to the
step's closed-form position (``seek(step)``) and draws its batch there
(``_next_target_batch``).  Bit for bit: the batches each step consumes,
the epoch and learning rate, ``current_epoch()`` before each step that
takes a staged batch, the losses and the final state, across epoch boundaries where the accumulation factor
changes, ``seek()`` and out-of-order steps, two ``Run.fit`` calls and
accumulation; a step takes a staged batch exactly when the step before
it was the one before it.  The ``cuda`` test holds a pinned slot against
being written while its copy is still in flight:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_staging.py
"""
import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.api import build, get_preset
from repro_torch.data import synth
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.pipeline import PipelineConfig, build_pipeline
from torch_threads import one_torch_thread  # noqa: F401


def _pipe(device="cpu", warmup_epochs=1):
    """400 edges, 64-row microbatches (6 an epoch); after ``warmup_epochs``
    epochs of one microbatch a step, two (3 steps an epoch)."""
    data = synth.generate_bipartite(40, 30, 400, seed=0)
    cfg = PipelineConfig(arch="lightgcn", embed_dim=8, n_layers=1,
                         base_batch=64, target_batch=128, microbatch=64,
                         warmup_epochs=warmup_epochs, seed=3)
    return build_pipeline(cfg, data, device=device)


def _rows(users, pos, neg):
    return [np.asarray(a, dtype=np.int64) for a in (users, pos, neg)]


def _record(pipe):
    """Per step: the epoch ``current_epoch()`` gave before it, whether it
    took a batch the step before staged (it staged none of its own), the
    batch's rows, the epoch it ran in and the learning rate."""
    seen = []
    step_fn, grads, update, stage, lr_for = (
        pipe.step_fn, pipe._grads, pipe.apply_update, pipe._stage,
        pipe.lr_for_epoch)

    def rec_step(state, step):
        seen.append({"step": step, "ahead": pipe.current_epoch(),
                     "hit": True})
        return step_fn(state, step)

    def rec_lr(epoch):
        seen[-1]["epoch"] = epoch
        return lr_for(epoch)

    def rec_stage(step):
        if step == seen[-1]["step"]:
            seen[-1]["hit"] = False
        return stage(step)

    def rec_grads(params, users, pos, neg):
        seen[-1]["rows"] = _rows(users, pos, neg)
        return grads(params, users, pos, neg)

    def rec_update(state, g, lr):
        seen[-1]["lr"] = float(lr)
        return update(state, g, lr)

    pipe.step_fn, pipe._grads, pipe.apply_update, pipe._stage, \
        pipe.lr_for_epoch = rec_step, rec_grads, rec_update, rec_stage, rec_lr
    return seen


def _oracle(pipe, state, steps):
    """``steps`` from ``state`` on a fresh ``pipe`` with nothing staged:
    each from its closed-form loader position.  Per step its epoch, rows
    and learning rate; the losses and the final state."""
    seen, losses = [], []
    for step in steps:
        pipe.seek(step)
        epoch = pipe.current_epoch()
        rows = pipe._next_target_batch(
            pipe.plan.microbatches_for_epoch(epoch), step)
        loss, grads = pipe.grads_for_batch(state["params"], *rows)
        lr = torch.full((), pipe.lr_for_epoch(epoch), dtype=torch.float32)
        state = pipe.apply_update(state, grads, lr)
        seen.append({"step": step, "epoch": epoch, "lr": float(lr),
                     "rows": _rows(*rows)})
        losses.append(loss)
    return seen, losses, state


def _drive_steps(warmup_epochs, plan):
    def drive():
        pipe = _pipe(warmup_epochs=warmup_epochs)
        seen = _record(pipe)
        state, losses = pipe.init_state(), []
        for s in plan:
            if isinstance(s, tuple):             # ("seek", step)
                pipe.seek(s[1])
                seen.append({"seek": s[1]})
                continue
            state, loss = pipe.step_fn(state, s)
            losses.append(loss)
        fresh = _pipe(warmup_epochs=warmup_epochs)
        return seen, losses, state, fresh, fresh.init_state()
    return drive


def _drive_fits():
    """quickstart: 28 one-microbatch steps an epoch for two epochs, then
    7 steps of four; the second fit crosses that boundary."""
    run = build(get_preset("quickstart"), device="cpu")
    seen = _record(run.pipeline)
    losses = list(run.fit(steps=50).losses)
    losses += run.fit(steps=15).losses
    fresh = build(get_preset("quickstart"), device="cpu")
    return seen, losses, run.state, fresh.pipeline, fresh.state


CASES = {
    # k 1 -> 2 at step 6, the learning rate with it; epochs at 6, 9
    "epoch_boundary": _drive_steps(1, range(12)),
    # explicit seeks mid-epoch, steps taken again, a step skipped
    "seek_mid_epoch": _drive_steps(1, [0, 1, 2, ("seek", 3), 3, 4,
                                       ("seek", 7), 7, 8, 8, 3, 4, 6, 7,
                                       10]),
    "accum_k2": _drive_steps(0, range(8)),
    "two_fits": _drive_fits,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_steps_equal_inline_steps(case):
    """The run consumes the oracle's batches, epochs and learning rates,
    gives its losses and ends in its state, bit for bit; every step whose
    step before was the one before it takes a staged batch, the rest (the
    first, after a ``seek()`` or a jump) stage their own."""
    seen, losses, state, fresh, state0 = CASES[case]()
    steps = [r["step"] for r in seen if "seek" not in r]
    want, want_losses, want_state = _oracle(fresh, state0, steps)
    assert losses == want_losses
    got = [r for r in seen if "seek" not in r]
    assert len(got) == len(want)
    prev = None
    for r in seen:
        if "seek" in r:
            prev = None
            continue
        w = want.pop(0)
        assert (r["step"], r["epoch"], r["lr"]) == \
            (w["step"], w["epoch"], w["lr"])
        for u, v in zip(r["rows"], w["rows"]):
            np.testing.assert_array_equal(u, v)
        assert r["hit"] == (prev is not None and r["step"] == prev + 1), \
            r["step"]
        if r["hit"]:                # the staged batch's own epoch
            assert r["ahead"] == w["epoch"]
        prev = r["step"]
    for u, v in zip(tree_leaves(state), tree_leaves(want_state)):
        assert torch.equal(u, v)


# before the counted steps: nothing, or steps 0 and 1; then the first
# counted step, 0 or 7, which seeks into epoch 2 (3 steps an epoch) and
# drops the batch staged for step 2
_STARTS = {"from_step_0": ([], 0), "after_a_seek": ([0, 1], 7)}


@pytest.mark.parametrize("start", sorted(_STARTS))
def test_a_staged_step_counts_its_stage_span_and_one_wait(start):
    """On the CPU a step waits once (the loss read); four steps enter
    ``step::stage`` five times (each the next step's, and the first its
    own) and ``step::batch`` once, in the first, which finds no batch
    staged for it.  The steps and the step staged after them cross an
    epoch boundary: two epochs handed over (``step::perm``), only the
    first drawn inline (``step::perm_draw``)."""
    before_steps, first = _STARTS[start]
    pipe = _pipe(warmup_epochs=0)
    state = pipe.init_state()
    for s in before_steps:
        state, _ = pipe.step_fn(state, s)
    trace.enable(True)
    try:
        before = trace.snapshot()
        for s in range(first, first + 4):
            state, _ = pipe.step_fn(state, s)
        d = trace.delta(before, trace.snapshot())
    finally:
        trace.enable(False)
    counts = {n: c for n, (c, _) in d["spans"].items()}
    assert d["counters"]["host_waits"] == 4
    assert counts["step::stage"] == 5
    assert counts["step::batch"] == 1
    assert counts["host_wait::loss"] == 4
    assert (counts["step::perm"], counts["step::perm_draw"]) == (2, 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned memory and events)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_slot_is_not_written_while_its_copy_is_in_flight(card,
                                                          monkeypatch):
    """Three stagings back to back behind a long kernel: the third takes
    the first's slot while the first's copy still waits in the stream.
    It waits for it (one host wait, ``staging``) and the first batch
    arrives intact.  With the slot's event forged to report its copy done
    (a program that writes a slot without waiting), the first batch
    arrives holding the third's rows: the check has teeth."""
    want = _pipe(warmup_epochs=0)
    k = want.plan.microbatches_for_epoch(0)
    batches = [want._next_target_batch(k, s) for s in range(5)]

    def first_of_three():
        pipe = _pipe(device=card, warmup_epochs=0)
        pipe._stage(0)
        pipe._stage(1)                      # both slots allocated
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 30)          # ~0.6 s of the stream
        before = trace.snapshot()
        pipe._stage(2)
        first = pipe._staged
        pipe._stage(3)
        pipe._stage(4)
        waits = trace.delta(before, trace.snapshot())
        torch.cuda.synchronize()
        assert first[0] == 2
        return [t.cpu().numpy() for t in first[2:]], \
            waits["counters"]["host_waits"]

    rows, waits = first_of_three()
    assert waits == 1
    for got, ref in zip(rows, batches[2]):
        np.testing.assert_array_equal(got, ref)

    monkeypatch.setattr(torch.cuda.Event, "query", lambda self: True)
    rows, waits = first_of_three()
    assert waits == 0
    assert any(not np.array_equal(got, ref)
               for got, ref in zip(rows, batches[2]))
    for got, ref in zip(rows, batches[4]):
        np.testing.assert_array_equal(got, ref)

"""One-step-ahead staging of the training step's target batch
(``Pipeline._stage``).

On the card each step builds the next step's batch once its own work is
enqueued and copies it from a pinned slot while the card runs.  The CPU
tests turn the staging on for a CPU pipeline (it is off there) and hold
a staged run to an inline one bit for bit: the batches each step
consumes, the learning rate, ``current_epoch()`` before each step, the
losses and the final state, across epoch boundaries where the
accumulation factor changes, ``seek()`` and out-of-order steps, two
``Run.fit`` calls and accumulation.  The ``cuda`` test holds a pinned
slot against being written while its copy is still in flight:

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


def _record(pipe):
    """Per step: the epoch ``current_epoch()`` gave before it, whether its
    batch was staged, the batch's rows and the learning rate."""
    seen = []
    step_fn, grads, update = pipe.step_fn, pipe._grads, pipe.apply_update

    def rec_step(state, step):
        seen.append({"step": step, "epoch": pipe.current_epoch()})
        return step_fn(state, step)

    def rec_grads(params, users, pos, neg):
        seen[-1]["staged"] = isinstance(users, torch.Tensor)
        seen[-1]["rows"] = [np.asarray(a, dtype=np.int64)
                            for a in (users, pos, neg)]
        return grads(params, users, pos, neg)

    def rec_update(state, g, lr):
        seen[-1]["lr"] = float(lr)
        return update(state, g, lr)

    pipe.step_fn, pipe._grads, pipe.apply_update = \
        rec_step, rec_grads, rec_update
    return seen


def _drive_steps(warmup_epochs, plan):
    def drive(staged):
        pipe = _pipe(warmup_epochs=warmup_epochs)
        pipe._stage_ahead = staged
        seen = _record(pipe)
        state, losses = pipe.init_state(), []
        for s in plan:
            if isinstance(s, tuple):             # ("seek", step)
                pipe.seek(s[1])
                seen.append({"seek": s[1]})
                continue
            state, loss = pipe.step_fn(state, s)
            losses.append(loss)
        return seen, losses, state
    return drive


def _drive_fits(staged):
    """quickstart: 28 one-microbatch steps an epoch for two epochs, then
    7 steps of four; the second fit crosses that boundary."""
    run = build(get_preset("quickstart"), device="cpu")
    run.pipeline._stage_ahead = staged
    seen = _record(run.pipeline)
    losses = list(run.fit(steps=50).losses)
    losses += run.fit(steps=15).losses
    return seen, losses, run.state


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
    """The staged run consumes the inline run's batches, epochs and
    learning rates, gives its losses and ends in its state, bit for bit;
    every step whose step before was the one before it takes a staged
    batch, the rest (the first, after a ``seek()`` or a jump) build
    inline."""
    drive = CASES[case]
    inline, staged = drive(False), drive(True)
    (si, li, xi), (ss, ls, xs) = inline, staged
    assert li == ls
    assert len(si) == len(ss)
    prev = None
    for a, b in zip(si, ss):
        if "seek" in b:
            assert a == b
            prev = None
            continue
        assert (a["step"], a["epoch"], a["lr"]) == \
            (b["step"], b["epoch"], b["lr"])
        for u, v in zip(a["rows"], b["rows"]):
            np.testing.assert_array_equal(u, v)
        assert not a["staged"]
        assert b["staged"] == (prev is not None
                               and b["step"] == prev + 1), b["step"]
        prev = b["step"]
    for u, v in zip(tree_leaves(xi), tree_leaves(xs)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("staged", [False, True])
def test_a_staged_step_counts_its_stage_span_and_one_wait(staged):
    """On the CPU a step waits once (the loss read) staged or not; a
    staged run enters ``step::stage`` once a step and ``step::batch``
    only in the step that builds inline (once, and once an upload: three
    a microbatch).  The four steps (3 an epoch) cross an epoch boundary:
    two epochs handed over (``step::perm``), only the first drawn inline
    (``step::perm_draw``), staged or not."""
    pipe = _pipe(warmup_epochs=0)
    pipe._stage_ahead = staged
    state = pipe.init_state()
    trace.enable(True)
    try:
        before = trace.snapshot()
        for s in range(4):
            state, _ = pipe.step_fn(state, s)
        d = trace.delta(before, trace.snapshot())
    finally:
        trace.enable(False)
    counts = {n: c for n, (c, _) in d["spans"].items()}
    assert d["counters"]["host_waits"] == 4
    assert counts.get("step::stage", 0) == (4 if staged else 0)
    assert counts["step::batch"] == (1 if staged else 4) * (1 + 3 * 2)
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
        assert pipe._stage_ahead
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

"""Fault-tolerant training loop (the port of ``repro/runtime/loop.py``,
with the same semantics).

Design: the training state (params and optimizer state) is one tree of
tensors, and the step is a function of it and the step number (the
pipeline seeks its loader and seeds its negatives by step).  Fault tolerance is
therefore exactly (a) periodic atomic checkpoints, (b) on start, resume
from the latest committed step, (c) on failure, the supervisor re-launches
the same binary and (b) takes over — the loop below is that logic.

Straggler mitigation: SPMD training has no per-worker skew knob inside a
step, so mitigation lives at the step boundary — a per-step deadline; a
step exceeding it is recorded, and after ``max_strays`` consecutive slow
steps the loop requests re-layout (a callback: the pipeline's
``on_relayout``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: str | None = None     # None -> in-memory run (no resume)
    ckpt_every: int = 50
    max_steps: int = 200
    step_deadline_s: float | None = None
    max_strays: int = 3
    async_ckpt: bool = True
    eval_every: int | None = None   # held-out eval cadence (steps); None=off


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    resumed_from: int | None
    stray_steps: int
    relayout_requests: int
    losses: list
    # (step, metrics dict) per eval_every firing — the train-time metric
    # history (paper Table 3's recall@20 tracked during training)
    eval_history: list = dataclasses.field(default_factory=list)
    # the state after the last step — callers (repro_torch.api.Run) continue
    # from here without a checkpoint round-trip
    final_state: Any = None


def run_training(cfg: LoopConfig, init_state: Any,
                 step_fn: Callable[[Any, int], tuple[Any, float]],
                 on_relayout: Callable[[Any], Any] | None = None,
                 on_restore: Callable[[Any], Any] | None = None,
                 eval_fn: Callable[[Any, int], dict] | None = None,
                 start_step: int = 0,
                 step_context: Callable[[], Any] | None = None,
                 ckpt_example: Any = None,
                 to_checkpoint: Callable[[Any], Any] | None = None,
                 writer: bool = True) -> LoopReport:
    """step_fn(state, step) -> (state, loss).  Resumes if a checkpoint
    exists (``on_restore`` post-processes the restored state — e.g.
    re-applying memory-tier placements that raw checkpoint leaves lose);
    checkpoints every ``ckpt_every``; final state saved at end.
    ``eval_fn(state, step) -> metrics`` fires every ``cfg.eval_every``
    steps and its results accumulate in ``LoopReport.eval_history``.
    ``cfg.ckpt_dir=None`` runs in memory: no restore, no saves.
    ``start_step`` positions the loop when ``init_state`` has already
    trained that far (``repro_torch.api.Run`` continuing in memory); a
    restored checkpoint overrides it.  ``step_context`` (zero-arg, returns
    a context manager) is entered around every step the loop drives
    (``Pipeline.step_context``: the sharding hints of a sharded run).

    Sharded runs: a checkpoint restores into ``ckpt_example`` (default
    ``init_state``) before ``on_restore``; ``to_checkpoint`` maps the state
    to what is written (the unsharded state: a collective, so every rank
    calls it), and only the ``writer`` rank writes."""
    start = start_step
    state = init_state
    resumed = None
    if cfg.ckpt_dir is not None and latest_step(cfg.ckpt_dir) is not None:
        state, start = restore_checkpoint(
            cfg.ckpt_dir, init_state if ckpt_example is None
            else ckpt_example)
        resumed = start
        if on_restore is not None:
            state = on_restore(state)
    strays = 0
    relayouts = 0
    losses = []
    evals = []
    pending = None
    for step in range(start, cfg.max_steps):
        t0 = time.perf_counter()
        if step_context is not None:
            with step_context():
                state, loss = step_fn(state, step)
        else:
            state, loss = step_fn(state, step)
        dt = time.perf_counter() - t0
        losses.append(float(loss))
        if (eval_fn is not None and cfg.eval_every
                and (step + 1) % cfg.eval_every == 0):
            evals.append((step + 1, eval_fn(state, step + 1)))
        if cfg.step_deadline_s is not None and dt > cfg.step_deadline_s:
            strays += 1
            if strays >= cfg.max_strays:
                relayouts += 1
                strays = 0
                if on_relayout is not None:
                    state = on_relayout(state)
        else:
            strays = 0
        if cfg.ckpt_dir is not None and (step + 1) % cfg.ckpt_every == 0:
            if pending is not None:
                pending.join()
            tree = state if to_checkpoint is None else to_checkpoint(state)
            pending = save_checkpoint(cfg.ckpt_dir, step + 1, tree,
                                      async_=cfg.async_ckpt) \
                if writer else None
    if pending is not None:
        pending.join()
    if cfg.ckpt_dir is not None:
        tree = state if to_checkpoint is None else to_checkpoint(state)
        if writer:
            save_checkpoint(cfg.ckpt_dir, cfg.max_steps, tree)
    return LoopReport(cfg.max_steps - start, resumed, strays, relayouts,
                      losses, evals, final_state=state)


def run_pipeline(cfg: LoopConfig, pipeline) -> LoopReport:
    """Drive a ``repro_torch.pipeline.Pipeline`` under the fault-tolerant
    loop: the pipeline supplies the initial state, the accumulated-
    microbatch ``step_fn``, ``on_relayout`` (re-plans and re-places the
    state), ``restore_state`` (shards restored leaves and places them on
    their tiers) and what a checkpoint writes (``checkpoint_state``)."""
    return run_training(cfg, pipeline.init_state(), pipeline.step_fn,
                        on_relayout=pipeline.on_relayout,
                        on_restore=pipeline.restore_state,
                        eval_fn=getattr(pipeline, "eval_fn", None),
                        step_context=getattr(pipeline, "step_context", None),
                        ckpt_example=pipeline.checkpoint_example(),
                        to_checkpoint=pipeline.checkpoint_state,
                        writer=pipeline.is_writer)

"""Run — the live handle ``build(spec)`` returns (the port of
``repro/api/run.py``).

One object that drives the port's stack from a spec: data loading
(``api.data``), planner + engine (``pipeline``), the fault-tolerant loop
(``runtime``), streaming evaluation and the serving facade (``eval``,
``serving``).  The spec stays the single source of truth; the Run adds
position (current state + step) and the device it runs on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.data import load_data
from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.data.synth import InteractionData
from repro_torch.pipeline import build_pipeline
from repro_torch.runtime.loop import LoopConfig, LoopReport, run_training


class Run:
    """One experiment's live state: pipeline + current (state, step)."""

    def __init__(self, spec: ExperimentSpec, train: InteractionData,
                 holdout: InteractionData | None = None, device="cuda"):
        self.spec = spec
        self.train_data = train
        self.holdout = holdout
        self.pipeline = build_pipeline(spec.to_pipeline_config(), train,
                                       holdout=holdout, device=device)
        self.state = self.pipeline.init_state()
        self.step_count = 0
        self.report: LoopReport | None = None
        self._recommender = None

    # ------------------------------------------------------------ training
    def step(self) -> float:
        """Advance one pipeline step (one accumulated target batch), under
        the pipeline's step context (the loop does the same for
        ``fit()``-driven steps)."""
        with self.pipeline.step_context():
            self.state, loss = self.pipeline.step_fn(self.state,
                                                     self.step_count)
        self.step_count += 1
        self._recommender = None
        return float(loss)

    def fit(self, steps: int | None = None,
            ckpt_dir: str | None = None) -> LoopReport:
        """Run ``steps`` more steps (default ``spec.loop.steps``) under
        the fault-tolerant loop.  With a checkpoint directory (argument
        or ``spec.loop.ckpt_dir``) the loop checkpoints periodically and
        resumes from the latest committed step; without one it runs
        in-memory.  Periodic held-out eval fires every
        ``spec.loop.eval_every`` steps when the run has a holdout.  On a
        sharded run every rank calls it; rank 0 writes the checkpoints,
        every leaf unsharded."""
        lc = self.spec.loop
        steps = lc.steps if steps is None else int(steps)
        ckpt_dir = ckpt_dir if ckpt_dir is not None else lc.ckpt_dir
        max_steps = self.step_count + steps
        cfg = LoopConfig(
            ckpt_dir=ckpt_dir,
            ckpt_every=lc.ckpt_every or max(steps // 2, 1),
            max_steps=max_steps, step_deadline_s=lc.step_deadline_s,
            max_strays=lc.max_strays, async_ckpt=lc.async_ckpt,
            eval_every=lc.eval_every)
        pipe = self.pipeline
        self.report = run_training(
            cfg, self.state, pipe.step_fn,
            on_relayout=pipe.on_relayout,
            on_restore=pipe.restore_state,
            eval_fn=pipe.eval_fn,
            start_step=self.step_count,
            step_context=pipe.step_context,
            ckpt_example=pipe.checkpoint_example(),
            to_checkpoint=pipe.checkpoint_state, writer=pipe.is_writer)
        self.state = self.report.final_state
        self.step_count = max_steps
        self._recommender = None
        return self.report

    def resume(self, ckpt_dir: str) -> "Run":
        """Position this run at the latest committed checkpoint: state
        restored onto its planned tiers, loader seeked so the next
        batch matches an uninterrupted run's (schedule-exact resume).  A
        checkpoint the reference's ``Run`` wrote restores too, and one of a
        sharded run restores onto any shard count."""
        state, step = restore_checkpoint(ckpt_dir,
                                         self.pipeline.checkpoint_example())
        self.state = self.pipeline.restore_state(state)
        self.pipeline.seek(step)
        self.step_count = step
        self._recommender = None
        return self

    # ------------------------------------------------------------ schedule
    def steps_for_epochs(self, n_epochs: int) -> int:
        return self.pipeline.steps_for_epochs(n_epochs)

    @property
    def params(self):
        return self.state["params"]

    # ------------------------------------------------------------ eval
    def embeddings(self):
        """Final (user, item) embeddings at the current state (whole, on
        every rank of a sharded run)."""
        return self.pipeline.embeddings(self.state)

    def evaluate(self) -> dict:
        """One held-out streaming-eval sweep (recall/NDCG@k + MRR); every
        rank of a sharded run returns the same metrics."""
        return self.pipeline.evaluate(self.state)

    # ------------------------------------------------------------ serving
    def recommender(self, **kw):
        """Serving facade over the current state's embeddings (placed
        snapshot, train items as the seen-exclusion set)."""
        from repro_torch.eval import Recommender
        kw.setdefault("k", self.spec.eval.k)
        kw.setdefault("item_block", self.spec.eval.item_block)
        kw.setdefault("cache_rows", self.spec.serve.cache_rows)
        kw.setdefault("fused", self.spec.serve.fused)
        kw.setdefault("ann", self.spec.serve.ann)
        kw.setdefault("keep_frac", self.spec.serve.keep_frac)
        return Recommender.from_pipeline(self.pipeline, self.state, **kw)

    def service(self, *, clock=None, **kw):
        """Queue-fronted serving: a ``RecommenderService`` wiring the
        coalescing queue (``spec.serve.queue_*`` knobs) → the ANN index
        (when ``spec.serve.ann``) → the placed ``Recommender``."""
        from repro_torch.serving import RecommenderService
        return RecommenderService(
            self.recommender(**kw),
            max_batch=self.spec.serve.queue_max_batch,
            max_wait_us=self.spec.serve.queue_max_wait_us,
            clock=clock)

    def recommend(self, user_ids, k: int | None = None,
                  exclude_seen: bool = True):
        """Batched top-K (ids, scores); snapshot cached until the next
        training step invalidates it."""
        if self._recommender is None:
            self._recommender = self.recommender()
        return self._recommender.recommend(np.asarray(user_ids), k=k,
                                           exclude_seen=exclude_seen)

    def describe(self) -> str:
        """The run's line, the shard plan's when there is one, then its
        ``TrainPlan.describe()``."""
        d = self.train_data
        lines = [f"Run[{self.spec.name}] arch={self.spec.model.arch} "
                 f"data={self.spec.data.source}:{self.spec.data.dataset} "
                 f"({d.n_users}U x {d.n_items}I, {d.n_edges} train edges)"]
        if self.pipeline.shard is not None:
            lines.append("  " + self.pipeline.shard.describe())
        lines.append(self.pipeline.plan.describe())
        return "\n".join(lines)


def build(spec: ExperimentSpec, train: InteractionData | None = None,
          holdout: InteractionData | None = None, device="cuda") -> Run:
    """spec -> Run on ``device``.  Data comes from ``spec.data`` unless an
    explicit train (and optional holdout) InteractionData is passed in.  A
    sharded spec needs one process per shard, each calling ``build``."""
    if train is None:
        train, holdout = load_data(spec.data)
    return Run(spec, train, holdout=holdout, device=device)

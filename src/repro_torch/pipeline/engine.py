"""Training engine (the port of ``repro/pipeline/engine.py``).

One ``Pipeline`` holds a run's graph, model, optimizer, large-batch
schedule, placement plan and loader, and exposes the loop-consumable
``step_fn(state, step) -> (state, loss)``:

  TrainPlan            — placement over the run's actual tensor set on the
                         configured topology and policy, the microbatch
                         derived from the fast tier's headroom unless
                         given (``pipeline.plan``), re-run on the loop's
                         re-layout requests;
  TieredExecutor       — demoted leaves live in a pinned host store,
                         fetched to the card once per step and committed
                         back after the update (``memory.executor``);
  LargeBatchSchedule   — per-epoch batch and LR (warm-up batch =
                         target/10 for the first epochs, linear scaling);
  microbatch gradient accumulation — the target batch B runs as
                         ceil(B/microbatch) microbatches whose gradients
                         are combined weighted by chunk size;
  GradCompressor       — optional int8/top-k gradient compression with
                         error feedback (``pipeline.compress``), its state
                         under ``state["comp"]``;
  kernel-routed models — registry forwards aggregate through the CUDA
                         kernels (``pipeline.sparse``), whose backwards
                         are kernels too;
  EdgeLoader           — deterministic, resumable microbatch stream;
  one-step-ahead batch — on every device and route, each step builds the
                         next step's target batch after enqueueing its own
                         work and starts its copy from a pinned slot while
                         the card runs (``Pipeline._stage``), so the loader
                         stands a step ahead of the caller;

ShardPlan (``pipeline.shard``) — sharded execution, one process per
                         shard: row-sharded tables and Adam moments, the
                         ring SpMM (``dist.ring_spmm``), every rank's
                         slice of each global chunk, the loss and the
                         replicated leaves' gradients all-reduced, the
                         row-sharded leaves' reduce-scattered to their
                         owners, each step under ``dist.hints``.

The step runs eagerly; there is nothing to compile.  The state is
``{"params", "opt"}`` (plus ``"comp"`` under gradient compression) of
nested dicts and lists of tensors, as the reference's pytrees; on a
sharded run each rank holds its row block of every leaf that has >= 2
dims and a leading dim divisible by P, and the whole of every other leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import bpr
from repro_torch.core.large_batch import LargeBatchSchedule
from repro_torch.data.loader import EdgeLoader, LoaderState
from repro_torch.data.synth import InteractionData, group_by_user
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import (all_gather_rows, all_reduce_,
                                          gather_rows, rank_of)
from repro_torch.dist.hints import sharding_hints
from repro_torch.eval.metrics import evaluate_embeddings
from repro_torch.memory import TieredExecutor, get_topology
from repro_torch.optim import adam, sgd
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.pipeline.plan import build_train_plan, derive_eval_batch
from repro_torch.pipeline.registry import get_model
from repro_torch.pipeline.shard import ShardPlan
from repro_torch.pipeline.sparse import BipartiteCSR
from repro_torch import trace


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The reference's fields and defaults.  ``impl`` is the port's kernel
    dispatch (None: by device, 'torch': the plain versions, 'cuda'), or
    'ring' to force the ring aggregation on one shard."""
    arch: str = "lightgcn"
    embed_dim: int = 32
    n_layers: int = 2
    optimizer: str = "adam"            # 'adam' | 'sgd'
    base_lr: float = 1e-3
    base_batch: int = 256
    target_batch: int = 2048
    microbatch: int | None = None      # None -> derived from HBM headroom;
    #                                    per shard when the mesh has P > 1
    warmup_epochs: int = 2
    lr_scaling: str = "linear"         # 'linear' | 'sqrt' (paper ablation)
    l2: float = 1e-4
    hbm_budget: int | None = None      # fast-tier budget override (bytes)
    impl: str | None = None            # None | 'torch' | 'cuda' | 'ring'
    hadamard: str = "auto"             # NGCF route: 'auto' | 'fused' | 'composed'
    seed: int = 0
    memory_topology: str = "tpu-hbm-host"     # repro_torch.memory
    memory_policy: str = "greedy"
    memory_capacity: dict | None = None
    memory_pins: dict | None = None
    mesh_shape: tuple[int, ...] = (1,)        # sharded execution
    mesh_axes: tuple[str, ...] | None = None  # None -> auto axis names
    spmm: str | None = None                   # None (auto) | 'ring'
    ring_steps: int | None = None             # banded ring (n_steps < P)
    grad_compression: str = "none"            # 'none' | 'int8' | 'topk'
    compression_frac: float = 0.01
    compression_ef: bool = True
    embed_store: str = "fp32"                 # 'fp32' | 'int8' slow tier
    ring_compression: str = "none"            # 'none' | 'int8' ring payload
    eval_k: int = 20
    eval_user_batch: int | None = None  # None -> derived from HBM headroom
    eval_item_block: int = 1024


class Pipeline:
    """One training run: state, plan, and the step the loop executes."""

    def __init__(self, cfg: PipelineConfig, train: InteractionData,
                 holdout: InteractionData | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = get_model(cfg.arch)
        # one ShardPlan flows through every layer below; None = the inert
        # single-device path.  impl='ring' forces the ring route on one
        # shard when no mesh is configured
        self.shard = ShardPlan.from_config(
            cfg.mesh_shape, cfg.mesh_axes, cfg.spmm, cfg.ring_steps,
            ring_quant=(cfg.ring_compression == "int8"))
        if cfg.impl == "ring" and self.shard is None:
            self.shard = ShardPlan(spmm="ring")
        # raises unless the world size is the shard count
        self.group = self.shard.process_group(self.device) \
            if self.shard is not None else None
        self.rank = rank_of(self.group)
        if self.group is not None and self.device.type == "cuda" \
                and self.device.index is None:
            # each rank's own card (torchrun's LOCAL_RANK, set as current)
            self.device = torch.device("cuda", torch.cuda.current_device())
        kernel_impl = None if cfg.impl == "ring" else cfg.impl
        self.g = BipartiteCSR(train.user, train.item, train.n_users,
                              train.n_items, device=self.device,
                              impl=kernel_impl, hadamard=cfg.hadamard,
                              shard=self.shard)
        # the kernel route the plan names: the port's own, never the
        # reference's pallas/xla
        impl = kernel_impl or ("cuda" if self.device.type == "cuda"
                               else "torch")

        params = self.spec.init(cfg.seed, self.g.n_users, self.g.n_items,
                                cfg.embed_dim, cfg.n_layers,
                                device=self.device)
        self.opt = {"adam": adam, "sgd": sgd}[cfg.optimizer](cfg.base_lr)
        opt_state = self.opt.init(params)

        sched = LargeBatchSchedule(base_lr=cfg.base_lr,
                                   base_batch=cfg.base_batch,
                                   target_batch=cfg.target_batch,
                                   warmup_epochs=cfg.warmup_epochs,
                                   scaling=cfg.lr_scaling)
        self.topology = get_topology(cfg.memory_topology) \
            .with_capacity(cfg.memory_capacity or {})
        self.plan = build_train_plan(cfg.arch, self.spec, params, opt_state,
                                     self.g, cfg.n_layers, cfg.embed_dim,
                                     sched, impl, hbm_budget=cfg.hbm_budget,
                                     microbatch=cfg.microbatch,
                                     shard=self.shard,
                                     topology=self.topology,
                                     policy=cfg.memory_policy,
                                     pins=cfg.memory_pins,
                                     embed_store=cfg.embed_store)
        self.executor = TieredExecutor(self.plan.plan,
                                       embed_store=cfg.embed_store,
                                       device=self.device)
        # compressed gradient combine (None = exact fp32).  Its state
        # rides the training state under "comp": the executor's
        # place/fetch/commit walk only params and opt
        self.compressor = None
        if cfg.grad_compression != "none":
            from repro_torch.pipeline.compress import GradCompressor
            self.compressor = GradCompressor(
                cfg.grad_compression, cfg.compression_frac,
                cfg.compression_ef, shard=self.shard, group=self.group)
        state0 = {"params": params, "opt": opt_state}
        if self.compressor is not None:
            state0["comp"] = self.compressor.init_state(params, cfg.seed)
        # the whole state's shapes and dtypes, without its storage: what a
        # row-sharded leaf gathers to, and the checkpoint's example
        self._full = tree_map(
            lambda t: torch.empty((), dtype=t.dtype,
                                  device=t.device).expand(t.shape), state0)
        self._state0 = self.apply_plan(self.shard_state(state0))
        del state0, params, opt_state

        self.loader = EdgeLoader(train.user, train.item,
                                 batch=self.plan.global_microbatch,
                                 seed=cfg.seed)
        self._next_step = 0                # the step the loader builds next
        self._staged = None                # (step, start, users, pos, neg)
        self._slots = [None, None]         # pinned int32 [3 * rows] each
        self._copied = [None, None]        # each slot's event after its copy
        self.eval_fn = None                # (state, step) -> metrics dict
        self._test_pos = None
        if holdout is not None:
            self.attach_holdout(holdout)

    # ---------------------------------------------------------------- state
    def init_state(self):
        """The placed initial state from the seeded init.  To start from
        other params — e.g. the reference's, carried over by
        ``convert.params_from_jax`` — pair them with ``opt.init(params)``
        and place them with ``restore_state``."""
        return self._state0

    def _sharded(self, full_leaf) -> bool:
        return self.shard is not None \
            and self.shard.shard_divisor(tuple(full_leaf.shape)) > 1

    def shard_state(self, tree):
        """This rank's part of a whole state (or of a subtree shaped like
        ``params``): ``ShardPlan.shard_state``; identity without a plan."""
        if self.shard is None:
            return tree
        return self.shard.shard_state(tree, self.rank)

    def _unshard(self, tree, full):
        return tree_map(lambda t, ex: all_gather_rows(t, self.group)
                        if self._sharded(ex) else t, tree, full)

    def unshard_state(self, state):
        """The whole state from every rank's part (a collective: every rank
        calls it); identity without a sharded plan."""
        return self._unshard(state, self._full)

    def _gather_params(self, params):
        """Whole params for the forward, differentiably: row-sharded leaves
        all-gathered (their gradients reduce-scatter to the owners)."""
        return tree_map(lambda t, ex: gather_rows(t, self.group)
                        if self._sharded(ex) else t,
                        params, self._full["params"])

    def restore_state(self, state):
        """A whole state (a restored checkpoint, or params from elsewhere
        with their optimizer state) -> this rank's part, placed on its
        tiers.  A checkpoint restores onto any shard count."""
        return self.apply_plan(self.shard_state(state))

    def checkpoint_example(self):
        """The tree a checkpoint restores into: the initial state, or on a
        sharded run the whole state's shapes, dtypes and devices."""
        if self.shard is None or not self.shard.is_sharded:
            return self._state0
        return self._full

    def checkpoint_state(self, state):
        """What a checkpoint writes: the whole state, every leaf unsharded
        (a collective on a sharded run; demoted leaves fetched first)."""
        if self.shard is None or not self.shard.is_sharded:
            return state
        return self.unshard_state(self.executor.fetch(state))

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes checkpoints and logs (rank 0)."""
        return self.rank == 0

    def apply_plan(self, state):
        """Place every state leaf onto its planned memory tier (used on
        fresh state, after re-layout and on checkpoint restore): demoted
        ``params``/``opt`` leaves into the executor's host store, the rest
        onto the pipeline's device; ``step_fn`` then fetches the demoted
        ones once per step and commits them back."""
        state, self.n_offloaded = self.executor.place(state)
        return state

    def step_context(self):
        """The context one engine step runs under; the loop enters it
        around every step it drives: the dp axis and the process group as
        sharding hints (``dist.hints``) on a sharded run, nothing on an
        unsharded one."""
        if self.shard is None:
            return contextlib.nullcontext()
        return sharding_hints(dp=self.shard.dp, group=self.group)

    @property
    def sched(self) -> LargeBatchSchedule:
        return self.plan.sched

    def out_dim(self) -> int:
        """Final embedding width, per the model's own contract."""
        return self.spec.out_dim(self.cfg.embed_dim, self.cfg.n_layers)

    def lr_for_epoch(self, epoch: int) -> float:
        """LR scaled to the batch actually run this epoch: the schedule's
        batch rounded up to whole global microbatches (every shard's
        samples count), so a sharded run scales as the single-device run
        with the same global batch."""
        actual = self.plan.microbatches_for_epoch(epoch) \
            * self.plan.global_microbatch
        return self.plan.sched.scaled_lr(actual)

    def steps_per_epoch(self, epoch: int) -> int:
        spe_micro = self.loader.steps_per_epoch()
        return max(1, spe_micro // self.plan.microbatches_for_epoch(epoch))

    def steps_for_epochs(self, n_epochs: int) -> int:
        return sum(self.steps_per_epoch(e) for e in range(n_epochs))

    # ---------------------------------------------------------------- step
    def _batch(self, a) -> torch.Tensor:
        """Index array -> int64 tensor on the device.  ``step_fn`` passes
        its staged batch, which is one already and passes as it is; a
        direct caller of ``value_and_grad`` or ``grads_for_batch`` may pass
        numpy, uploaded here from pageable host memory, which waits for
        the card's queue to drain: a host wait."""
        if isinstance(a, torch.Tensor) and a.dtype == torch.int64 \
                and a.device.type == self.device.type:
            return a
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if a.device.type == "cpu" and self.device.type != "cpu":
            with trace.host_wait("upload"):
                return a.to(self.device, torch.int64)
        return a.to(self.device, torch.int64)

    def loss(self, params, users, pos, neg) -> torch.Tensor:
        """The BPR loss of one microbatch through the model's forward
        (``users``/``pos``/``neg`` are index tensors on the device)."""
        ue, ie = self.spec.forward(params, self.g, self.cfg.n_layers)
        return bpr.bpr_loss(ue, ie, users, pos, neg, l2=self.cfg.l2)

    def value_and_grad(self, params, users, pos, neg, weight=None):
        """(loss, grads) of one microbatch; ``grads`` has ``params``'
        structure.  The params are not modified.  On a sharded run the
        loss is this rank's slice's, times ``weight`` (slice / batch),
        taken through the whole params (``_gather_params``): a row-sharded
        leaf's gradient arrives reduce-scattered, summed over the ranks;
        a replicated leaf's is this rank's part alone."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if weight is None or len(users):
            users, pos, neg = (self._batch(a) for a in (users, pos, neg))
        with torch.enable_grad():
            with trace.span("step::forward"):
                if weight is None:
                    loss = self.loss(live, users, pos, neg)
                elif len(users):
                    loss = self.loss(self._gather_params(live), users, pos,
                                     neg) * weight
                else:
                    # a rank with no rows still runs the forward and
                    # backward: their collectives need every rank
                    ue, ie = self.spec.forward(self._gather_params(live),
                                               self.g, self.cfg.n_layers)
                    loss = (ue.sum() + ie.sum()) * 0.0
            with trace.span("step::backward"):
                grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        return loss.detach(), tree_map(lambda _: next(grads), params)

    def grads_for_batch(self, params, users, pos, neg):
        """Microbatched gradient accumulation over one target batch.

        Per-chunk mean-loss gradients are combined weighted by chunk size,
        so the result equals the full-batch gradient even when the batch
        is not a microbatch multiple.  Returns (mean_loss, grads).

        A sharded run chunks at the global microbatch; each rank takes its
        rows of each chunk (``ShardPlan.shard_batch``) and weights its loss
        by its rows over the batch's, then the loss and the replicated
        leaves' gradients are all-reduced (the row-sharded leaves' were
        reduce-scattered in the backward)."""
        loss, acc = self._grads(params, users, pos, neg)
        with trace.host_wait("loss"):
            loss = float(loss)
        return loss, acc

    def _grads(self, params, users, pos, neg):
        """``grads_for_batch`` with the loss left on the device."""
        mu = self.plan.global_microbatch
        n = len(users)
        k = max(1, math.ceil(n / mu))
        loss_sum = None      # device scalar: no host sync inside the loop
        acc = None
        for c in range(k):
            sl = slice(c * mu, min((c + 1) * mu, n))
            u, p, ng = users[sl], pos[sl], neg[sl]
            if self.shard is not None:
                u, p, ng = self.shard.shard_batch(u, p, ng, rank=self.rank)
            wl, wg = self.micro_grads(params, u, p, ng, n)
            loss_sum = wl if loss_sum is None else loss_sum + wl
            acc = wg if acc is None else tree_map(torch.add, acc, wg)
        return self.combine(loss_sum, acc)

    def micro_grads(self, params, users, pos, neg, n: int):
        """One chunk's (loss, grads) weighted by its rows over the target
        batch's ``n``: on one device the chunk's mean-loss gradients times
        chunk / n; on a sharded run this rank's slice's (``users`` are its
        rows of the chunk), the weight taken inside the backward."""
        if self.shard is None:
            w = len(users) / n
            loss, grads = self.value_and_grad(params, users, pos, neg)
            return loss * w, tree_map(lambda t: t * w, grads)
        return self.value_and_grad(params, users, pos, neg,
                                   weight=len(users) / n)

    def combine(self, loss, grads):
        """The accumulated (loss, grads) across the ranks: the loss and
        the replicated leaves' gradients all-reduced in place (the
        row-sharded leaves' were reduce-scattered in the backward);
        identity on one device."""
        if self.shard is not None:
            all_reduce_(loss, self.group)
            tree_map(lambda t, ex: t if self._sharded(ex)
                     else all_reduce_(t, self.group),
                     grads, self._full["params"])
        return loss, grads

    def _next_target_batch(self, k: int, step: int):
        """Drain k loader microbatches into one (u, i+, i-) target batch.
        Negatives are seeded per (run seed, step) so a resumed run draws
        the same samples as an uninterrupted one."""
        us, ps = [], []
        for _ in range(k):
            u, i = next(self.loader)
            us.append(u)
            ps.append(i)
        users = np.concatenate(us)
        pos = np.concatenate(ps)
        rng = np.random.default_rng((self.cfg.seed, step))
        neg = rng.integers(0, self.g.n_items, len(users)).astype(np.int32)
        return users, pos, neg

    def _micro_pos(self) -> int:
        """Loader position as a linear microbatch counter (the loader
        rolls epochs lazily, so consumption is exactly ``+= 1``)."""
        st = self.loader.state
        return st.epoch * self.loader.steps_per_epoch() + st.step

    def current_epoch(self) -> int:
        """The epoch the next step's first microbatch comes from (a staged
        batch's own: the loader is a step ahead of it)."""
        start = self._staged[1] if self._staged is not None \
            else self._micro_pos()
        return start // self.loader.steps_per_epoch()

    def consumed_epoch(self) -> int:
        """The loader's epoch as the steps run so far leave it, the batch
        staged for the next step not counted: the reference's
        ``loader.state.epoch`` after the same steps.  It rolls lazily, so
        a step that ends an epoch leaves it in that epoch."""
        if self._staged is not None:
            return max(0, self._staged[1] - 1) // \
                self.loader.steps_per_epoch()
        return self.loader.state.epoch

    def seek(self, step: int) -> None:
        """Position the loader as if ``step`` pipeline steps had already
        run (same epoch, accumulation factor and sample order), in closed
        form over epoch segments."""
        spe = self.loader.steps_per_epoch()
        g = 0
        done = 0
        while done < step:
            e = g // spe
            k = self.plan.microbatches_for_epoch(e)
            # steps until the next epoch boundary can change k (the step
            # crossing the boundary still uses this epoch's k)
            t = min(step - done, max(1, math.ceil(((e + 1) * spe - g) / k)))
            g += t * k
            done += t
        if g == 0:
            self.loader.state = LoaderState(0, 0)
        else:
            e = (g - 1) // spe
            self.loader.state = LoaderState(e, g - e * spe)
        self._next_step = step
        self._staged = None

    def step_fn(self, state, step: int):
        """(state, step) -> (state, loss): one accumulated update.  Demoted
        leaves come to the device once for the whole step (the tables do
        not change inside one accumulated batch) and go back after the
        update; identity when nothing is demoted.

        Every step takes its batch from ``_stage``, on every device and
        route: the one the step before staged for it, or, for a step with
        none staged for it (the first, one after ``seek`` and any other
        out of order), one it stages itself at its own time, inside
        ``step::batch``.  Once its work is enqueued, the step stages the
        next one's, then reads its loss: one host wait, which ends with
        the card's queue.  So the loader stands a step ahead of the
        caller between steps (``current_epoch``, ``consumed_epoch``)."""
        if self._staged is None or self._staged[0] != step:
            if step != self._next_step:
                self.seek(step)
            with trace.span("step::batch"):
                self._stage(step)
        _, start, users, pos, neg = self._staged
        self._staged = None
        epoch = start // self.loader.steps_per_epoch()
        with trace.span("step::fetch"):
            state = self.executor.fetch(state)
        loss, grads = self._grads(state["params"], users, pos, neg)
        lr = torch.full((), self.lr_for_epoch(epoch), dtype=torch.float32,
                        device=self.device)
        with trace.span("step::update"):
            out = self.apply_update(state, grads, lr)
        self._stage(step + 1)
        with trace.span("step::commit"):
            state = self.executor.commit(out)
        with trace.host_wait("loss"):
            loss = float(loss)
        return state, loss

    def _stage(self, step: int) -> None:
        """Build ``step``'s target batch now (``_next_target_batch`` at the
        loader's position) and start it on its way to the device: the
        three int32 index arrays into one of two host slots (the step's
        parity; pinned on the card), one ``non_blocking`` copy on the
        current stream, widened to int64 there.  On the CPU the copy is
        the slot itself and the widening copies out of it; a sharded rank
        slices its rows of each chunk from the staged tensors.  A slot is
        written again only after its last copy has run (an event recorded
        after it; waited on, a host wait, only if it has not passed)."""
        with trace.span("step::stage"):
            start = self._micro_pos()
            users, pos, neg = self._next_target_batch(
                self.plan.microbatches_for_epoch(
                    start // self.loader.steps_per_epoch()), step)
            self._next_step = step + 1
            n, slot = len(users), step & 1
            buf, copied = self._slots[slot], self._copied[slot]
            if buf is None or buf.numel() < 3 * n:
                # a slot that grows is freed to torch's pinned cache, which
                # holds the block until its last copy has run
                buf = self._slots[slot] = torch.empty(
                    3 * n, dtype=torch.int32,
                    pin_memory=self.device.type == "cuda")
            elif copied is not None and not copied.query():
                with trace.host_wait("staging"):
                    copied.synchronize()
            host = buf[:3 * n].view(3, n)
            rows = host.numpy()
            rows[0], rows[1], rows[2] = users, pos, neg
            idx = host.to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                if copied is None:
                    copied = self._copied[slot] = torch.cuda.Event()
                copied.record(torch.cuda.current_stream(self.device))
            users, pos, neg = idx.to(torch.int64).unbind(0)
            self._staged = (step, start, users, pos, neg)

    def apply_update(self, state, grads, lr: torch.Tensor):
        """The update half of a step (the reference's ``_apply_update``):
        gradient compression when configured, then the optimizer, on the
        fetched state; returns the new {"params", "opt"[, "comp"]}."""
        out = {}
        with torch.no_grad():
            if self.compressor is not None:
                # the reference compresses shares of the whole combined
                # gradient, so a sharded run gathers it first
                grads = self._unshard(grads, self._full["params"])
                grads, out["comp"] = self.compressor(grads, state["comp"])
                grads = self.shard_state(grads)
            out["params"], out["opt"] = self.opt.update(
                grads, state["opt"], state["params"], lr=lr)
        return out

    def on_relayout(self, state):
        """The loop's straggler escalation: re-run the planner over the
        current tensor set (the microbatch kept) and re-place the state.
        A sharded run re-plans per shard over the whole leaves' shapes."""
        cfg = self.cfg
        full = state if self.shard is None else self._full
        self.plan = build_train_plan(
            cfg.arch, self.spec, full["params"], full["opt"], self.g,
            cfg.n_layers, cfg.embed_dim, self.sched, self.plan.impl,
            hbm_budget=cfg.hbm_budget, microbatch=self.plan.microbatch,
            shard=self.shard, topology=self.topology,
            policy=cfg.memory_policy, pins=cfg.memory_pins,
            embed_store=cfg.embed_store)
        self.executor = TieredExecutor(self.plan.plan,
                                       embed_store=cfg.embed_store,
                                       device=self.device)
        return self.apply_plan(state)

    # ---------------------------------------------------------------- eval
    def embeddings(self, state):
        """Final (user, item) embeddings for evaluation, from the device
        copies of any demoted leaves (``executor.fetch``); on a sharded run
        the whole embeddings on every rank (a collective)."""
        params = self.executor.fetch(state)["params"]
        with torch.no_grad():
            params = self._unshard(params, self._full["params"])
            return self.spec.forward(params, self.g, self.cfg.n_layers)

    def attach_holdout(self, holdout: InteractionData) -> None:
        """Enable ``evaluate`` and periodic held-out evaluation: held-out
        items grouped by user (train items are masked through the CSR
        structure), and ``eval_fn``, which the fault-tolerant loop calls
        every ``LoopConfig.eval_every`` steps."""
        self._test_pos = group_by_user(holdout.user, holdout.item,
                                       self.g.n_users)

        def eval_fn(state, step):
            return self.evaluate(state)

        self.eval_fn = eval_fn

    def eval_user_batch(self) -> int:
        """User microbatch for one eval sweep: configured, or derived
        from the fast tier left after the training plan's placements."""
        if self.cfg.eval_user_batch is not None:
            return int(self.cfg.eval_user_batch)
        free = self.plan.hbm_budget - self.plan.plan.hbm_used
        return derive_eval_batch(free, self.out_dim(), self.cfg.eval_k,
                                 self.cfg.eval_item_block)

    def evaluate(self, state) -> dict:
        """One held-out sweep (recall/NDCG@eval_k + MRR) on ``state``."""
        if self._test_pos is None:
            raise RuntimeError("no holdout attached; call attach_holdout")
        ue, ie = self.embeddings(state)
        indptr, items = self.g.seen_csr()
        return evaluate_embeddings(
            ue, ie, self._test_pos, k=self.cfg.eval_k,
            seen_indptr=indptr, seen_items=items,
            user_batch=self.eval_user_batch(),
            item_block=self.cfg.eval_item_block, impl=self.g.impl,
            device=self.device, shard=self.shard)


def build_pipeline(cfg: PipelineConfig, train: InteractionData,
                   holdout: InteractionData | None = None,
                   device="cuda") -> Pipeline:
    return Pipeline(cfg, train, holdout=holdout, device=device)

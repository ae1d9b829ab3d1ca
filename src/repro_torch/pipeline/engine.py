"""Training engine (the port of ``repro/pipeline/engine.py``).

One ``Pipeline`` holds a run's graph, model, optimizer, large-batch
schedule and loader, and exposes the loop-consumable
``step_fn(state, step) -> (state, loss)``:

  LargeBatchSchedule   — per-epoch batch and LR (warm-up batch =
                         target/10 for the first epochs, linear scaling);
  microbatch gradient accumulation — the target batch B runs as
                         ceil(B/microbatch) microbatches whose gradients
                         are combined weighted by chunk size;
  kernel-routed models — registry forwards aggregate through the CUDA
                         kernels (``pipeline.sparse``), whose backwards
                         are kernels too;
  EdgeLoader           — deterministic, resumable microbatch stream.

The step runs eagerly; there is nothing to compile.  The reference's
planner and memory tiers (ROADMAP A5), mesh execution (A10) and
compression (A9) are not ported yet: a config that asks for any of them
raises ``NotImplementedError`` naming its item, so nothing is ignored
silently.  Until they land, the hooks the fault-tolerant loop and
``api.Run`` call (``apply_plan``, ``on_relayout``, ``step_context``)
keep the whole state on the pipeline's device, and ``shard`` is None.
The state is ``{"params", "opt"}`` of nested dicts and lists of tensors,
as the reference's pytrees.
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
from repro_torch.eval.metrics import evaluate_embeddings
from repro_torch.eval.topk import DEFAULT_USER_BATCH
from repro_torch.optim import adam, sgd
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.pipeline.plan import TrainPlan
from repro_torch.pipeline.registry import get_model
from repro_torch.pipeline.sparse import BipartiteCSR


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The reference's fields and defaults.  ``impl`` is the port's kernel
    dispatch (None: by device, 'torch': the plain versions, 'cuda')."""
    arch: str = "lightgcn"
    embed_dim: int = 32
    n_layers: int = 2
    optimizer: str = "adam"            # 'adam' | 'sgd'
    base_lr: float = 1e-3
    base_batch: int = 256
    target_batch: int = 2048
    microbatch: int | None = None      # None -> derived by the planner (A5)
    warmup_epochs: int = 2
    lr_scaling: str = "linear"         # 'linear' | 'sqrt' (paper ablation)
    l2: float = 1e-4
    hbm_budget: int | None = None      # planner (A5)
    impl: str | None = None            # None | 'torch' | 'cuda'
    hadamard: str = "auto"             # NGCF route: 'auto' | 'fused' | 'composed'
    seed: int = 0
    memory_topology: str = "tpu-hbm-host"     # planner (A5)
    memory_policy: str = "greedy"
    memory_capacity: dict | None = None
    memory_pins: dict | None = None
    mesh_shape: tuple[int, ...] = (1,)        # sharded execution (A10)
    mesh_axes: tuple[str, ...] | None = None
    spmm: str | None = None
    ring_steps: int | None = None
    grad_compression: str = "none"            # compression (A9)
    compression_frac: float = 0.01
    compression_ef: bool = True
    embed_store: str = "fp32"
    ring_compression: str = "none"
    eval_k: int = 20
    eval_user_batch: int | None = None  # None -> the port's default batch
    eval_item_block: int = 1024


def check_ported(cfg: PipelineConfig) -> None:
    """Raise ``NotImplementedError`` naming the options ``cfg`` sets that
    the port cannot run yet, each with the ROADMAP item that brings it."""
    asks = {
        "microbatch=None (derived by the planner, A5)": cfg.microbatch is None,
        "hbm_budget (planner, A5)": cfg.hbm_budget is not None,
        "memory_topology/memory_policy/memory_capacity/memory_pins "
        "(memory tiers, A5)": (cfg.memory_topology != "tpu-hbm-host"
                               or cfg.memory_policy != "greedy"
                               or bool(cfg.memory_capacity)
                               or bool(cfg.memory_pins)),
        "mesh_shape/mesh_axes/spmm/ring_steps/impl='ring' (sharded "
        "execution, A10)": (tuple(cfg.mesh_shape) != (1,)
                            or cfg.mesh_axes is not None
                            or cfg.spmm is not None
                            or cfg.ring_steps is not None
                            or cfg.impl == "ring"),
        "grad_compression/ring_compression/embed_store='int8' "
        "(compression, A9)": (cfg.grad_compression != "none"
                              or cfg.ring_compression != "none"
                              or cfg.embed_store != "fp32"),
    }
    asked = [name for name, on in asks.items() if on]
    if asked:
        raise NotImplementedError(
            f"PipelineConfig options the port does not have yet "
            f"(ROADMAP item in brackets): {asked}")


class Pipeline:
    """One training run: graph, model, optimizer, schedule and loader."""

    def __init__(self, cfg: PipelineConfig, train: InteractionData,
                 holdout: InteractionData | None = None, device="cuda"):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = get_model(cfg.arch)
        self.g = BipartiteCSR(train.user, train.item, train.n_users,
                              train.n_items, device=self.device,
                              impl=cfg.impl, hadamard=cfg.hadamard)
        self.opt = {"adam": adam, "sgd": sgd}[cfg.optimizer](cfg.base_lr)
        sched = LargeBatchSchedule(base_lr=cfg.base_lr,
                                   base_batch=cfg.base_batch,
                                   target_batch=cfg.target_batch,
                                   warmup_epochs=cfg.warmup_epochs,
                                   scaling=cfg.lr_scaling)
        self.plan = TrainPlan(sched, int(cfg.microbatch))
        self.loader = EdgeLoader(train.user, train.item,
                                 batch=self.plan.microbatch,
                                 seed=cfg.seed)
        self._next_step = 0
        self._state0 = None
        self.shard = None                  # one card: no mesh (A10)
        self.n_offloaded = 0               # nothing demoted (A5)
        self.eval_fn = None                # (state, step) -> metrics dict
        self._test_pos = None
        if holdout is not None:
            self.attach_holdout(holdout)

    # ---------------------------------------------------------------- state
    def init_state(self):
        """{"params", "opt"} from the seeded init (built on first call).
        To start from other params — e.g. the reference's, carried over by
        ``convert.params_from_jax`` — pair them with ``opt.init(params)``."""
        if self._state0 is None:
            params = self.spec.init(self.cfg.seed, self.g.n_users,
                                    self.g.n_items, self.cfg.embed_dim,
                                    self.cfg.n_layers, device=self.device)
            self._state0 = {"params": params, "opt": self.opt.init(params)}
        return self._state0

    def apply_plan(self, state):
        """Place every state leaf where the plan puts it (used on fresh
        state, after re-layout and on checkpoint restore).  Without the
        planner (ROADMAP A5) every leaf goes to the pipeline's device and
        nothing is offloaded."""
        self.n_offloaded = 0
        return tree_map(lambda t: t.to(self.device), state)

    def step_context(self):
        """The context one engine step runs under; the loop enters it
        around every step it drives.  Nothing on one card (the reference's
        sharding hints are ROADMAP A10)."""
        return contextlib.nullcontext()

    @property
    def sched(self) -> LargeBatchSchedule:
        return self.plan.sched

    def out_dim(self) -> int:
        """Final embedding width, per the model's own contract."""
        return self.spec.out_dim(self.cfg.embed_dim, self.cfg.n_layers)

    def lr_for_epoch(self, epoch: int) -> float:
        """LR scaled to the batch actually run this epoch: the schedule's
        batch rounded up to whole microbatches."""
        actual = self.plan.microbatches_for_epoch(epoch) \
            * self.plan.microbatch
        return self.plan.sched.scaled_lr(actual)

    def steps_per_epoch(self, epoch: int) -> int:
        spe_micro = self.loader.steps_per_epoch()
        return max(1, spe_micro // self.plan.microbatches_for_epoch(epoch))

    def steps_for_epochs(self, n_epochs: int) -> int:
        return sum(self.steps_per_epoch(e) for e in range(n_epochs))

    # ---------------------------------------------------------------- step
    def _batch(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            torch.int64)

    def loss(self, params, users, pos, neg) -> torch.Tensor:
        """The BPR loss of one microbatch through the model's forward
        (``users``/``pos``/``neg`` are index tensors on the device)."""
        ue, ie = self.spec.forward(params, self.g, self.cfg.n_layers)
        return bpr.bpr_loss(ue, ie, users, pos, neg, l2=self.cfg.l2)

    def value_and_grad(self, params, users, pos, neg):
        """(loss, grads) of one microbatch; ``grads`` has ``params``'
        structure.  The params are not modified."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = self.loss(live, self._batch(users), self._batch(pos),
                             self._batch(neg))
            grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        return loss.detach(), tree_map(lambda _: next(grads), params)

    def grads_for_batch(self, params, users, pos, neg):
        """Microbatched gradient accumulation over one target batch.

        Per-chunk mean-loss gradients are combined weighted by chunk size,
        so the result equals the full-batch gradient even when the batch
        is not a microbatch multiple.  Returns (mean_loss, grads)."""
        mu = self.plan.microbatch
        n = len(users)
        k = max(1, math.ceil(n / mu))
        loss_sum = None      # device scalar: no host sync inside the loop
        acc = None
        for c in range(k):
            sl = slice(c * mu, min((c + 1) * mu, n))
            w = (sl.stop - sl.start) / n
            loss, grads = self.value_and_grad(params, users[sl], pos[sl],
                                              neg[sl])
            wl = loss * w
            wg = tree_map(lambda t: t * w, grads)
            loss_sum = wl if loss_sum is None else loss_sum + wl
            acc = wg if acc is None else tree_map(torch.add, acc, wg)
        return float(loss_sum), acc

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
        """The epoch the next microbatch will come from."""
        return self._micro_pos() // self.loader.steps_per_epoch()

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

    def step_fn(self, state, step: int):
        """(state, step) -> (state, loss): one accumulated update."""
        if step != self._next_step:
            self.seek(step)
        epoch = self.current_epoch()
        k = self.plan.microbatches_for_epoch(epoch)
        users, pos, neg = self._next_target_batch(k, step)
        loss, grads = self.grads_for_batch(state["params"], users, pos, neg)
        lr = torch.tensor(self.lr_for_epoch(epoch), dtype=torch.float32,
                          device=self.device)
        with torch.no_grad():
            params, opt = self.opt.update(grads, state["opt"],
                                          state["params"], lr=lr)
        self._next_step = step + 1
        return {"params": params, "opt": opt}, loss

    def on_relayout(self, state):
        """The loop's straggler escalation: re-plan and re-place the state.
        The planner is ROADMAP A5; until then the placement is unchanged
        and the state is re-placed as ``apply_plan`` places it."""
        return self.apply_plan(state)

    # ---------------------------------------------------------------- eval
    def embeddings(self, state):
        """Final (user, item) embeddings for evaluation."""
        with torch.no_grad():
            return self.spec.forward(state["params"], self.g,
                                     self.cfg.n_layers)

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
        """User batch of one eval sweep: configured, else the port's
        default (the reference derives it from the planner's headroom;
        the metrics do not depend on it)."""
        if self.cfg.eval_user_batch is not None:
            return int(self.cfg.eval_user_batch)
        return DEFAULT_USER_BATCH

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
            device=self.device)


def build_pipeline(cfg: PipelineConfig, train: InteractionData,
                   holdout: InteractionData | None = None,
                   device="cuda") -> Pipeline:
    return Pipeline(cfg, train, holdout=holdout, device=device)

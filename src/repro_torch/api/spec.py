"""ExperimentSpec — the one declarative description of a run (the port of
``repro/api/spec.py``).

The paper's thesis (§5-§7) is that batch size, tensor placement, and
model depth must be co-tuned; ``ExperimentSpec`` is the single source of
truth for those knobs: nine typed sections (model / data / plan / mesh /
memory / compression / loop / eval / serve) plus the training
hyperparameters, with an exact ``to_dict``/``from_dict``/JSON round-trip
and dotted-path overrides so a CLI flag, a preset, and a spec file all
converge on the same object.  Every section, default and validation is
the reference's, so ``to_dict()`` equals the reference's key for key and
one JSON spec drives both packages.  ``repro_torch.api.build(spec)``
turns it into a ``Run``; the device is an argument of ``build``, never a
spec field.  What the port cannot run yet (the planner, sharding,
compression) the pipeline refuses when it is built, naming the ROADMAP
item.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Which architecture, how wide, how deep (paper Table 3 axes).
    ``hadamard`` picks NGCF's Hadamard-message route: 'auto' (fused
    everywhere except the ring dispatch), 'fused' (the no-[E, D]
    gather-multiply-aggregate kernel), 'composed' (the legacy edge
    SDDMM + edge-aggregation pair).  Non-NGCF models ignore it."""
    arch: str = "lightgcn"           # pipeline.registry key
    embed_dim: int = 32
    n_layers: int = 2
    hadamard: str = "auto"           # 'auto' | 'fused' | 'composed'

    def __post_init__(self):
        if self.hadamard not in ("auto", "fused", "composed"):
            raise ValueError(f"model.hadamard must be 'auto', 'fused' or "
                             f"'composed', got {self.hadamard!r}")


@dataclasses.dataclass(frozen=True)
class DataCfg:
    """Where interactions come from — one protocol over every source
    (``api.data.DATA_SOURCES``): 'synth' scales a named paper
    dataset's statistics, 'bipartite' generates explicit sizes,
    'kronecker' expands a scaled base graph (paper's m-x25 method)."""
    source: str = "synth"            # registered data-source name
    dataset: str = "movielens-10m"   # stats name (synth / kronecker)
    edges: int = 4000                # target edge count (pre-expansion)
    n_users: int | None = None       # explicit sizes ('bipartite')
    n_items: int | None = None
    expand_factor: int = 1           # kronecker edge multiplier
    test_frac: float = 0.1           # held-out split; 0 -> no holdout
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PlanCfg:
    """Placement + batching knobs consumed by ``pipeline.plan``."""
    hbm_budget: int | None = None    # planner budget override (bytes)
    target_batch: int = 2048         # §7.1 large-batch target
    microbatch: int | None = None    # None -> derived from HBM headroom
    base_batch: int = 256            # LR-scaling reference batch
    warmup_epochs: int = 2           # warm-up batch = target/10 epochs
    lr_scaling: str = "linear"       # 'linear' | 'sqrt'
    impl: str | None = None          # kernel dispatch override


@dataclasses.dataclass(frozen=True)
class MeshCfg:
    """Sharded execution (ROADMAP A10 in the port): mesh shape and
    axis names, SpMM dispatch, and the banded-ring knob.  The default
    ``shape=(1,)`` is the inert single-device plan — bit-identical to
    the unsharded pipeline."""
    shape: tuple[int, ...] = (1,)
    axes: tuple[str, ...] | None = None  # None -> auto axis names
    spmm: str | None = None          # None (auto: ring when P>1) | 'ring'
    ring_steps: int | None = None    # banded ring: visit n_steps < P owners

    def __post_init__(self):
        object.__setattr__(self, "shape",
                           tuple(int(s) for s in self.shape))
        if self.axes is not None:
            object.__setattr__(self, "axes",
                               tuple(str(a) for a in self.axes))
        if self.ring_steps is not None and self.ring_steps < 1:
            raise ValueError(f"mesh.ring_steps must be >= 1 (or null for "
                             f"the full ring), got {self.ring_steps}")


@dataclasses.dataclass(frozen=True)
class MemoryCfg:
    """Memory-tier subsystem (``memory``; training placement is ROADMAP A5
    in the port): which registered
    ``TierTopology`` the run models, which placement policy assigns
    tensors to tiers, per-tier capacity overrides, and name->tier pins.
    The default reproduces the pre-redesign TPU planner bit for bit;
    the paper's §5 Memory-Mode-vs-AppDirect comparison is a one-line
    change of ``topology``.  Exact JSON round-trip like ``MeshCfg``."""
    topology: str = "tpu-hbm-host"   # memory.topology_names()
    policy: str = "greedy"           # memory.policy_names()
    capacity: dict | None = None     # tier name -> bytes override
    pins: dict | None = None         # tensor (sub)name -> tier name
    #                                  (e.g. {"params['item_embed']": "slow"})

    def __post_init__(self):
        if self.capacity is not None:
            object.__setattr__(self, "capacity",
                               {str(k): int(v)
                                for k, v in self.capacity.items()})
        if self.pins is not None:
            object.__setattr__(self, "pins",
                               {str(k): str(v)
                                for k, v in self.pins.items()})


@dataclasses.dataclass(frozen=True)
class CompressionCfg:
    """Byte compression on the slow links (``optim.compression``; ROADMAP
    A9 in the port):
    the gradient combine (``grads``: int8 stochastic psum or top-k
    all-gather, with per-participant error feedback carried in
    ``state["comp"]``), capacity-tier embedding-table storage
    (``embed_store='int8'``: ~1/4 bytes, fp32 dequant-on-gather, and
    the planner prices the quantized footprint), and the ring-SpMM
    payload rotation (``ring='int8'``).  The default is the identity:
    no compressor is built and training stays bit-identical to the
    pre-compression pipeline."""
    grads: str = "none"              # 'none' | 'int8' | 'topk'
    frac: float = 0.01               # top-k kept fraction of each tensor
    error_feedback: bool = True      # carry compression residuals
    embed_store: str = "fp32"        # 'fp32' | 'int8' slow-tier tables
    ring: str = "none"               # 'none' | 'int8' ring payload

    def __post_init__(self):
        if self.grads not in ("none", "int8", "topk"):
            raise ValueError(f"compression.grads must be 'none', 'int8' "
                             f"or 'topk', got {self.grads!r}")
        if not 0.0 < float(self.frac) <= 1.0:
            raise ValueError(f"compression.frac must be in (0, 1], "
                             f"got {self.frac}")
        if self.embed_store not in ("fp32", "int8"):
            raise ValueError(f"compression.embed_store must be 'fp32' or "
                             f"'int8', got {self.embed_store!r}")
        if self.ring not in ("none", "int8"):
            raise ValueError(f"compression.ring must be 'none' or 'int8', "
                             f"got {self.ring!r}")
        object.__setattr__(self, "frac", float(self.frac))
        object.__setattr__(self, "error_feedback", bool(self.error_feedback))


@dataclasses.dataclass(frozen=True)
class LoopCfg:
    """Fault-tolerant-loop knobs consumed by ``runtime.loop``."""
    steps: int = 100
    ckpt_dir: str | None = None      # None -> in-memory run (no resume)
    ckpt_every: int | None = None    # None -> max(steps // 2, 1)
    eval_every: int | None = None    # held-out eval cadence; None = off
    step_deadline_s: float | None = None
    max_strays: int = 3
    async_ckpt: bool = False


@dataclasses.dataclass(frozen=True)
class EvalCfg:
    """Streaming top-K evaluation/serving shape (``eval``)."""
    k: int = 20
    user_batch: int | None = None    # None -> the engine's default batch
    item_block: int = 1024


@dataclasses.dataclass(frozen=True)
class ServeCfg:
    """Serving hot-path knobs (``eval.Recommender`` /
    ``serving.RecommenderService``): the hot-row cache budget in front
    of host-demoted embedding tables (device-resident LFU slots, priced
    against the fast tier by ``pipeline.plan.serving_profiles``), the
    fused gather+score+top-K kernel routing, the block-pruned ANN index
    (``serving.ann.AnnIndex``; ``keep_frac`` is the surviving-block
    fraction — 1.0 scans everything and is bit-identical to the exact
    streamed sweep), and the request-coalescing queue's two dispatch
    triggers.  Defaults are the identity: no cache, auto-fused, no ANN
    pruning — bit-identical results either way (pinned by
    the reference's tests/test_serving.py)."""
    cache_rows: int = 0              # device-resident hot rows; 0 = off
    fused: bool | None = None        # None = auto (device-resident items)
    ann: bool = False                # block-pruned approximate retrieval
    keep_frac: float = 1.0           # surviving block fraction, (0, 1]
    queue_max_batch: int = 64        # coalescing bound (pow2 bucket cap)
    queue_max_wait_us: int = 1_000   # oldest-request dispatch deadline

    def __post_init__(self):
        if int(self.cache_rows) < 0:
            raise ValueError(f"serve.cache_rows must be >= 0, "
                             f"got {self.cache_rows}")
        object.__setattr__(self, "cache_rows", int(self.cache_rows))
        if self.fused is not None:
            object.__setattr__(self, "fused", bool(self.fused))
        object.__setattr__(self, "ann", bool(self.ann))
        kf = float(self.keep_frac)
        if not 0.0 < kf <= 1.0:
            raise ValueError(f"serve.keep_frac must be in (0, 1], "
                             f"got {self.keep_frac}")
        object.__setattr__(self, "keep_frac", kf)
        if int(self.queue_max_batch) < 1:
            raise ValueError(f"serve.queue_max_batch must be >= 1, "
                             f"got {self.queue_max_batch}")
        object.__setattr__(self, "queue_max_batch",
                           int(self.queue_max_batch))
        if int(self.queue_max_wait_us) < 0:
            raise ValueError(f"serve.queue_max_wait_us must be >= 0, "
                             f"got {self.queue_max_wait_us}")
        object.__setattr__(self, "queue_max_wait_us",
                           int(self.queue_max_wait_us))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The whole experiment, declaratively."""
    name: str = "experiment"
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    data: DataCfg = dataclasses.field(default_factory=DataCfg)
    plan: PlanCfg = dataclasses.field(default_factory=PlanCfg)
    mesh: MeshCfg = dataclasses.field(default_factory=MeshCfg)
    memory: MemoryCfg = dataclasses.field(default_factory=MemoryCfg)
    compression: CompressionCfg = dataclasses.field(
        default_factory=CompressionCfg)
    loop: LoopCfg = dataclasses.field(default_factory=LoopCfg)
    eval: EvalCfg = dataclasses.field(default_factory=EvalCfg)
    serve: ServeCfg = dataclasses.field(default_factory=ServeCfg)
    optimizer: str = "adam"          # 'adam' | 'sgd'
    base_lr: float = 1e-3
    l2: float = 1e-4
    seed: int = 0

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        return _spec_from_dict(cls, d, where="spec")

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------- overrides
    def override(self, overrides: Mapping[str, Any] | None = None,
                 **kw: Any) -> "ExperimentSpec":
        """New spec with dotted-path fields replaced:
        ``spec.override({"model.embed_dim": 64, "plan.microbatch": 128})``.
        Top-level fields work too (``optimizer="sgd"`` or
        ``{"optimizer": "sgd"}``).  Unknown paths raise KeyError."""
        merged = {**(overrides or {}), **kw}
        spec = self
        for path, value in merged.items():
            spec = _replace_path(spec, path.split("."), value)
        return spec

    # ------------------------------------------------------- pipeline view
    def to_pipeline_config(self):
        """The engine-facing projection of this spec: the port's
        ``PipelineConfig`` (whose ``Pipeline`` raises, naming the ROADMAP
        item, on an option the port does not have yet)."""
        from repro_torch.pipeline import PipelineConfig
        return PipelineConfig(
            arch=self.model.arch, embed_dim=self.model.embed_dim,
            n_layers=self.model.n_layers, hadamard=self.model.hadamard,
            optimizer=self.optimizer,
            base_lr=self.base_lr, base_batch=self.plan.base_batch,
            target_batch=self.plan.target_batch,
            microbatch=self.plan.microbatch,
            warmup_epochs=self.plan.warmup_epochs,
            lr_scaling=self.plan.lr_scaling, l2=self.l2,
            hbm_budget=self.plan.hbm_budget, impl=self.plan.impl,
            seed=self.seed, mesh_shape=self.mesh.shape,
            mesh_axes=self.mesh.axes, spmm=self.mesh.spmm,
            ring_steps=self.mesh.ring_steps,
            memory_topology=self.memory.topology,
            memory_policy=self.memory.policy,
            memory_capacity=self.memory.capacity,
            memory_pins=self.memory.pins,
            grad_compression=self.compression.grads,
            compression_frac=self.compression.frac,
            compression_ef=self.compression.error_feedback,
            embed_store=self.compression.embed_store,
            ring_compression=self.compression.ring,
            eval_k=self.eval.k,
            eval_user_batch=self.eval.user_batch,
            eval_item_block=self.eval.item_block)


_SECTIONS = {"model": ModelCfg, "data": DataCfg, "plan": PlanCfg,
             "mesh": MeshCfg, "memory": MemoryCfg,
             "compression": CompressionCfg, "loop": LoopCfg,
             "eval": EvalCfg, "serve": ServeCfg}


def _fields(cls) -> dict:
    return {f.name: f for f in dataclasses.fields(cls)}


def _spec_from_dict(cls, d: Mapping[str, Any], where: str) -> ExperimentSpec:
    known = _fields(cls)
    unknown = set(d) - set(known)
    if unknown:
        raise ValueError(f"unknown {where} keys {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    kw: dict[str, Any] = {}
    for name, value in d.items():
        section = _SECTIONS.get(name)
        if section is not None:
            if not isinstance(value, Mapping):
                raise ValueError(f"{where}.{name} must be a mapping")
            sub_known = _fields(section)
            sub_unknown = set(value) - set(sub_known)
            if sub_unknown:
                raise ValueError(
                    f"unknown {where}.{name} keys {sorted(sub_unknown)}; "
                    f"known: {sorted(sub_known)}")
            kw[name] = section(**value)
        else:
            kw[name] = value
    return cls(**kw)


def _replace_path(obj, path: list[str], value):
    head = path[0]
    if not any(f.name == head for f in dataclasses.fields(obj)):
        raise KeyError(f"unknown spec field {'.'.join(path)!r}")
    if len(path) == 1:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(
        obj, **{head: _replace_path(getattr(obj, head), path[1:], value)})

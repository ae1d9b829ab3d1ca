"""Layer 2 — step auditor over dispatched ops (the port of
``repro/analysis/hlo_audit.py``; imports torch; import it explicitly).

The reference lowers its jitted train step and serve path and asserts on
the lowered text.  An eager program has no lowering: what it runs is the
sequence of ops one call dispatches.  ``OpRecorder`` (a
``TorchDispatchMode``) records that sequence for each half of a step, and
the same invariants are asserted on it:

  * **no f64**: no op outputs a float64 or complex128 tensor;
  * **no host reads inside the step**: no ``aten._local_scalar_dense``
    (``.item()``, ``float(t)``, ... — it shows on the CPU too), no copy
    from the card to the host, and on the card no copy to the card from
    pageable host memory; each read is attributed to the first frame of
    the port that issued it;
  * **collectives present/absent exactly per MeshCfg/CompressionCfg**
    over the train step's two halves together, through the reference's ``FRAGMENTS`` table, with c10d ops in place
    of HLO instructions: all-reduce is ``c10d.allreduce_``, all-gather
    ``c10d._allgather_base_``/``allgather_``, reduce-scatter
    ``c10d._reduce_scatter_base_``/``reduce_scatter_``,
    collective-permute the ring's ``c10d.send``/``recv_``; ``s8`` is an
    int8 payload on a ring op and ``s32`` an int32 payload on an
    all-reduce;
  * a **recompile-hazard count** (``recompile_hazard``, the reference's,
    pure): the schedule must feed one microbatch chunk shape.

The halves: ``micro_step`` (``Pipeline.micro_grads`` on one microbatch
and, on a sharded run, ``Pipeline.combine``: the counterpart of the
reference's jitted micro step, whose psum GSPMD places inside it;
recorded on its second call, after the first has built what the graph
memoizes and paid the dispatch mode's first use), ``apply_update``
(``Pipeline.apply_update``, where a compressed combine runs) and
``serve`` (the Recommender's row gather, ``eval.topk._gather_rows``, then
``ops.fused_topk_score`` on a snapshot).  Their inputs are staged on the
run's device before recording, as the reference lowers on device
batches.  On the card, ``torch.cuda.set_sync_debug_mode("warn")`` around
each half is a second witness; its warnings are counted.

On the CPU the kernels' plain versions run, and some read the host
(``int(dst[-1])`` in ``kernels/ref.py``); the card never takes them, so a
CPU audit exempts reads issued from ``PLAIN_SITES``.  A card audit holds
the whole path.

``smoke_audit(mesh=P)`` for P > 1 runs inside a process group of P ranks
(gloo on the CPU): under ``torchrun``, or the group a caller opened.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.roofline import C10D_KINDS, collective_bytes

__all__ = ["StepExpectation", "COLLECTIVES", "FRAGMENTS", "PLAIN_SITES",
           "OpRecord", "OpRecorder", "expect", "expectation_for",
           "check_ops", "assert_clean", "tokens", "summary",
           "record_train_step",
           "record_serve", "recompile_hazard", "message_shape",
           "ngcf_message_fragment", "fusion_audit", "audit_spec",
           "audit_run", "smoke_audit"]

# every collective kind the port's programs issue; the single-device
# expectation is their total absence
COLLECTIVES = ("collective-permute", "all-reduce", "all-gather",
               "all-to-all", "reduce-scatter")
# the plain versions' modules: host reads there are exempt on the CPU
PLAIN_SITES = ("repro_torch/kernels/ref.py",)
_COPIES = ("aten._to_copy.default", "aten.copy_.default")


def _is_f64(dt: torch.dtype) -> bool:
    """float64 or complex128: a 64-bit float, real or in each part."""
    return dt.itemsize == (16 if dt.is_complex else 8) \
        and (dt.is_floating_point or dt.is_complex)


@dataclasses.dataclass(frozen=True)
class StepExpectation:
    """What a recorded step must (not) contain, by token."""
    name: str
    contains: tuple[str, ...] = ()
    absent: tuple[str, ...] = ()

    def merged(self, other: "StepExpectation") -> "StepExpectation":
        contains = self.contains + tuple(
            c for c in other.contains if c not in self.contains)
        # a token any fragment requires can't simultaneously be
        # forbidden: contains wins
        absent = tuple(a for a in self.absent + other.absent
                       if a not in contains)
        absent = tuple(dict.fromkeys(absent))
        return StepExpectation(f"{self.name}+{other.name}",
                               tuple(c for c in contains
                                     if c not in absent), absent)


# the reference's table, fragment for fragment
FRAGMENTS = {
    # no mesh -> no collectives of any kind
    "single-device": StepExpectation("single-device", absent=COLLECTIVES),
    # ring SpMM rotates blocks with send/recv
    "ring-spmm": StepExpectation("ring-spmm",
                                 contains=("collective-permute",)),
    # quantized ring: the rotated payload really is int8
    "ring-spmm@int8": StepExpectation("ring-spmm@int8",
                                      contains=("collective-permute", "s8")),
    # sharded training all-reduces grads
    "grad-psum": StepExpectation("grad-psum", contains=("all-reduce",)),
    # int8 gradient combine: an integer all-reduce (int32 accumulate)
    "grad-combine@int8": StepExpectation("grad-combine@int8",
                                         contains=("all-reduce", "s32")),
    # top-k combine exchanges sparse shares via all-gather
    "grad-combine@topk": StepExpectation("grad-combine@topk",
                                         contains=("all-gather",)),
}


def message_shape(n_edges: int, embed_dim: int) -> tuple[str, tuple]:
    """The [E, D] float32 message buffer — the needle the fused-NGCF
    fragments look for — as (dtype name, shape)."""
    return ("float32", (int(n_edges), int(embed_dim)))


def ngcf_message_fragment(n_edges: int, embed_dim: int, *,
                          fused: bool) -> StepExpectation:
    """The graph-shaped half of the fused-NGCF contract: the composed
    step forms the [E, D] message buffer; the fused kernel route forms
    none (the plain fused route still gathers at that shape, so on the
    CPU the relative count in ``fusion_audit`` is the invariant)."""
    token = _shape_token(*message_shape(n_edges, embed_dim))
    if fused:
        return StepExpectation("ngcf-fused-messages", absent=(token,))
    return StepExpectation("ngcf-composed-messages", contains=(token,))


def expect(*names: str) -> StepExpectation:
    """Merge named ``FRAGMENTS`` into one expectation."""
    exp = FRAGMENTS[names[0]]
    for n in names[1:]:
        exp = exp.merged(FRAGMENTS[n])
    return exp


def expectation_for(*, n_shards: int = 1, grads: str = "none",
                    ring: str = "none") -> StepExpectation:
    """The full train-step expectation for a (MeshCfg, CompressionCfg)
    point: which fragments apply is a pure function of the config."""
    if n_shards <= 1:
        return expect("single-device")
    names = ["ring-spmm@int8" if ring == "int8" else "ring-spmm"]
    if grads == "topk":
        names.append("grad-combine@topk")
    elif grads == "int8":
        names.append("grad-combine@int8")
    else:
        names.append("grad-psum")
    return expect(*names)


# ------------------------------------------------------------------ record
@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its name (``aten.mm.default``), the (dtype,
    shape) of its tensor inputs and outputs, and for a host read its
    kind and the port's frame that issued it."""
    name: str
    tensors: tuple
    outputs: tuple
    host_read: str | None = None
    site: str | None = None


def _flat(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _site() -> str:
    """file:line of the innermost frame in the port outside this module
    (the frame that asked for the read)."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if "repro_torch/" in path and not path.endswith("step_audit.py"):
            return f"{path[path.index('repro_torch/'):]}:{frame.f_lineno}"
        frame = frame.f_back
    return "<outside the port>"


def _host_read(name: str, args, out) -> str | None:
    if name == "aten._local_scalar_dense.default":
        return "scalar read"
    if name not in _COPIES:
        return None
    src = args[1] if name == "aten.copy_.default" else args[0]
    dst = args[0] if name == "aten.copy_.default" else out
    if not (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)):
        return None
    if src.is_cuda and not dst.is_cuda:
        return "copy card->host"
    if dst.is_cuda and src.device.type == "cpu" and not src.is_pinned():
        return "copy from pageable host memory"
    return None


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched while active (``records``)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        ins = tuple((t.dtype, tuple(t.shape)) for t in _flat((args, kwargs)))
        outs = tuple((t.dtype, tuple(t.shape)) for t in _flat(out))
        read = _host_read(name, args, out)
        self.records.append(OpRecord(name, ins, outs, read,
                                     _site() if read else None))
        return out


def _is_sync_warning(w) -> bool:
    """The sync-debug mode's own warning (not its once-a-process notice
    that the mode is a prototype)."""
    return "called a synchronizing cuda operation" in str(w.message).lower()


def _collective_kind(name: str) -> str | None:
    if not name.startswith("c10d."):
        return None
    return C10D_KINDS.get(name.split(".")[1])


def _shape_token(dtype: str, shape: tuple) -> str:
    return f"{dtype}{list(shape)}"


def tokens(records) -> set[str]:
    """What a recorded step contains, in the expectations' vocabulary:
    the collective kinds, ``s8``/``s32`` per the payload rule, and a
    ``<dtype>[shape]`` token for every float32 tensor an op outputs."""
    out: set[str] = set()
    for r in records:
        kind = _collective_kind(r.name)
        if kind is not None:
            out.add(kind)
            dts = {dt for dt, _ in r.tensors}
            if kind == "collective-permute" and torch.int8 in dts:
                out.add("s8")
            if kind == "all-reduce" and torch.int32 in dts:
                out.add("s32")
        for dt, shape in r.outputs:
            if dt == torch.float32:
                out.add(_shape_token("float32", shape))
    return out


def summary(records) -> dict:
    """Counts for a report: ops, host reads by site, f64 ops,
    collectives by kind, and their payload bytes by kind
    (``launch.roofline.collective_bytes``)."""
    reads: dict[str, int] = {}
    colls: dict[str, int] = {}
    f64 = 0
    for r in records:
        if r.host_read:
            key = f"{r.host_read} @ {r.site}"
            reads[key] = reads.get(key, 0) + 1
        kind = _collective_kind(r.name)
        if kind:
            colls[kind] = colls.get(kind, 0) + 1
        f64 += any(_is_f64(dt) for dt, _ in r.outputs)
    return {"ops": len(records), "host_reads": reads, "f64_ops": f64,
            "collectives": colls,
            "collective_bytes": collective_bytes(records).by_kind}


# ------------------------------------------------------------------ checks
def check_ops(records, expectation: StepExpectation | None = None, *,
              forbid_f64: bool = True, forbid_host_transfer: bool = True,
              exempt_sites: tuple[str, ...] = (), where: str = ""
              ) -> list[str]:
    """Audit one recorded half; returns violations (the counterpart of
    the reference's ``check_text``)."""
    out = []
    tag = f"[{where}] " if where else ""
    if forbid_f64:
        for r in records:
            bad = [dt for dt, _ in r.outputs if _is_f64(dt)]
            if bad:
                out.append(f"{tag}f64 op in the step ({r.name} -> {bad[0]})"
                           ": a hot path widened past fp32")
                break
    if forbid_host_transfer:
        for r in records:
            if r.host_read and not any(s in (r.site or "")
                                       for s in exempt_sites):
                out.append(f"{tag}host read inside the step: {r.host_read} "
                           f"({r.name}) at {r.site}")
    if expectation is not None:
        have = tokens(records)
        for s in expectation.contains:
            if s not in have:
                out.append(f"{tag}expected {s!r} missing (expectation "
                           f"{expectation.name})")
        for s in expectation.absent:
            if s in have:
                out.append(f"{tag}forbidden {s!r} present (expectation "
                           f"{expectation.name})")
    return out


def assert_clean(records, expectation: StepExpectation | None = None,
                 **kw) -> None:
    """``check_ops`` raising AssertionError with every violation."""
    violations = check_ops(records, expectation, **kw)
    assert not violations, "; ".join(violations)


# ---------------------------------------------------------------- records
class _Half:
    """Records one half: the ops, the sync-debug warnings on the card,
    and its seconds."""

    def __init__(self, device: torch.device):
        self.device = device
        self.recorder = None
        self.sync_warnings = 0
        self.seconds = 0.0

    def run(self, fn):
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.recorder = OpRecorder()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with self.recorder:
                    out = fn()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
        if on_card:
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - t0
        self.sync_warnings = sum(map(_is_sync_warning, caught))
        return out


def _staged_batch(pipe):
    """One microbatch of the run's loader, this rank's rows of it, on the
    run's device (staged outside the recorded region)."""
    u, p, n = pipe._next_target_batch(1, 0)
    total = len(u)
    if pipe.shard is not None:
        u, p, n = pipe.shard.shard_batch(u, p, n, rank=pipe.rank)
    return tuple(pipe._batch(a) for a in (u, p, n)), total


def record_train_step(run) -> dict[str, _Half]:
    """The two recorded halves of one engine step (the microbatch value
    and grad with its combine, and the optimizer update) for a
    ``repro_torch.api.Run``, run as ``step_fn`` runs them."""
    pipe = run.pipeline
    state = pipe.executor.fetch(run.state)
    (u, p, n), total = _staged_batch(pipe)
    lr = torch.full((), 1e-3, dtype=torch.float32, device=pipe.device)

    def micro():
        return pipe.combine(*pipe.micro_grads(state["params"], u, p, n,
                                              total))

    halves = {"micro_step": _Half(pipe.device),
              "apply_update": _Half(pipe.device)}
    with pipe.step_context():
        # a first call, its record dropped, builds what the graph memoizes
        # (the ring's buckets: set-up, as the reference's host build is)
        # and pays the dispatch mode's own first use (seconds on a card
        # host, with one synchronisation of its own)
        with OpRecorder():
            micro()
        _, grads = halves["micro_step"].run(micro)
        halves["apply_update"].run(
            lambda: pipe.apply_update(state, grads, lr))
    return halves


def record_serve(run, *, k: int = 10, item_block: int = 256,
                 users: int = 8) -> dict[str, _Half]:
    """The serving hot path on a snapshot of the run's embeddings: the
    Recommender's row gather of ``users`` users, then the fused score ->
    mask -> top-K kernel route."""
    from repro_torch.eval.topk import _gather_rows
    from repro_torch.kernels import ops
    pipe = run.pipeline
    ue, ie = run.embeddings()
    dev = pipe.device
    ue, ie = ue.to(dev), ie.to(dev)
    ids = torch.arange(min(users, ue.shape[0]), dtype=torch.int64,
                       device=dev)
    seen = torch.zeros((ids.shape[0], 1), dtype=torch.int32, device=dev)
    mask = torch.zeros((ids.shape[0], 1), dtype=torch.bool, device=dev)
    n_items = int(ie.shape[0])
    impl = pipe.g.impl
    half = _Half(dev)

    def serve():
        rows = _gather_rows(ue, ids, impl)
        return ops.fused_topk_score(rows, ie, seen, mask,
                                    k=min(k, n_items),
                                    item_block=min(item_block, n_items),
                                    n_items=n_items, impl=impl)

    with torch.no_grad():
        half.run(serve)
    return {"serve": half}


def recompile_hazard(plan, n_epochs: int = 8,
                     batches: list[int] | None = None) -> list[int]:
    """Distinct microbatch chunk shapes ``Pipeline.grads_for_batch``
    would run across the schedule.  More than one distinct shape means
    the warm-up schedule varies the chunk shape, not the accumulation
    count (a recompile per shape in the reference; here a shape-keyed
    cache miss per shape).

    By default audits the engine's own feed (the loader-fed target
    batch, ``microbatches_for_epoch * global_microbatch`` per epoch).
    Pass ``batches`` to audit a direct ``grads_for_batch`` caller's batch
    sizes instead: any size that is not a microbatch multiple shows up
    here as the ragged trailing chunk it would run."""
    mu = plan.global_microbatch
    if batches is None:
        batches = [plan.microbatches_for_epoch(e) * mu
                   for e in range(n_epochs)]
    shapes = set()
    for n in batches:
        for c in range(max(1, math.ceil(n / mu))):
            shapes.add(min((c + 1) * mu, n) - c * mu)
    return sorted(shapes)


def _n_shards(spec) -> int:
    return math.prod(int(d) for d in spec.mesh.shape)


def audit_run(run, spec, *, serve: bool = True, n_epochs: int = 8
              ) -> tuple[list[str], dict]:
    """Audit a built run's halves: f64, host reads and collectives per
    the spec's MeshCfg + CompressionCfg, the serve path, the recompile
    hazard.  Returns (violations, per-half report)."""
    n_shards = _n_shards(spec)
    exp = expectation_for(n_shards=n_shards, grads=spec.compression.grads,
                          ring=spec.compression.ring)
    exempt = PLAIN_SITES if run.pipeline.device.type == "cpu" else ()
    halves = record_train_step(run)
    if serve:
        halves.update(record_serve(run))
    violations, report = [], {}
    # the collective contract binds the train step, both halves together:
    # the gradient combine sits in micro_step (the psum), a compressed
    # combine in apply_update (where the compressor runs)
    step = halves["micro_step"].recorder.records \
        + halves["apply_update"].recorder.records
    violations += check_ops(step, exp, forbid_f64=False,
                            forbid_host_transfer=False,
                            where=f"{spec.name}:step")
    for name, half in halves.items():
        # every half holds the f64/host invariants; the serve path, on a
        # snapshot, issues no collective on any mesh
        violations += check_ops(half.recorder.records,
                                expect("single-device") if name == "serve"
                                else None,
                                exempt_sites=exempt,
                                where=f"{spec.name}:{name}")
        if half.sync_warnings:
            violations.append(f"[{spec.name}:{name}] {half.sync_warnings} "
                              "sync-debug warning(s) on the card")
        report[name] = dict(summary(half.recorder.records),
                            sync_warnings=half.sync_warnings,
                            seconds=half.seconds)
    shapes = recompile_hazard(run.pipeline.plan, n_epochs=n_epochs)
    if len(shapes) != 1:
        violations.append(
            f"[{spec.name}:schedule] recompile hazard: {len(shapes)} "
            f"distinct microbatch chunk shapes {shapes} across the "
            "schedule (expected exactly 1)")
    return violations, report


def audit_spec(spec, *, serve: bool = True, n_epochs: int = 8,
               device="cuda") -> list[str]:
    """Build ``spec`` on ``device`` and audit every hot-path half
    (``audit_run``).  Returns all violations (empty = clean)."""
    from repro_torch.api import build
    return audit_run(build(spec, device=device), spec, serve=serve,
                     n_epochs=n_epochs)[0]


def fusion_audit(spec, *, where: str = "", device="cuda") -> list[str]:
    """The fused-NGCF train-step contract on the recorded micro steps:
    build the same spec at ``model.hadamard`` 'fused' and 'composed' and
    require

      * the composed step forms the float32 [E, D] message buffer;
      * the fused step forms it strictly less often; on the card, never
        (the kernel keeps the product on chip), while the CPU's plain
        fused route still gathers at [E, D], so there the relative count
        is the invariant.
    """
    from repro_torch.api import build
    recs, runs = {}, {}
    for had in ("fused", "composed"):
        s = spec.override({"model.hadamard": had,
                           "name": f"{spec.name}@{had}"})
        runs[had] = build(s, device=device)
        recs[had] = record_train_step(runs[had])["micro_step"] \
            .recorder.records
    g = runs["fused"].pipeline.g
    tag = f"[{where}] " if where else ""
    if not getattr(g, "fused_hadamard", False):
        return [f"{tag}model.hadamard='fused' did not resolve to the "
                "fused route"]
    out = check_ops(recs["composed"],
                    ngcf_message_fragment(g.n_edges, spec.model.embed_dim,
                                          fused=False),
                    forbid_f64=False, forbid_host_transfer=False,
                    where=f"{where}:composed")
    dtype, shape = message_shape(g.n_edges, spec.model.embed_dim)
    count = {had: sum(o == (torch.float32, shape)
                      for r in recs[had] for o in r.outputs)
             for had in recs}
    if count["fused"] >= count["composed"]:
        out.append(f"{tag}fused NGCF micro step forms the message shape "
                   f"{dtype}{list(shape)} {count['fused']}x vs composed "
                   f"{count['composed']}x — the fusion bought nothing")
    if runs["fused"].pipeline.device.type == "cuda":
        out += check_ops(recs["fused"],
                         ngcf_message_fragment(g.n_edges,
                                               spec.model.embed_dim,
                                               fused=True),
                         forbid_f64=False, forbid_host_transfer=False,
                         where=f"{where}:fused")
    return out


# ------------------------------------------------------------------ smoke
_SMOKE_OV = {"loop.steps": 5, "plan.target_batch": 64,
             "plan.microbatch": 16, "plan.warmup_epochs": 2,
             "data.edges": 1200, "loop.ckpt_dir": None}


def smoke_spec(mesh: int = 1, grads: str = "none", ring: str = "none",
               embed_store: str = "fp32", arch: str = "lightgcn"):
    """The ``{arch}-smoke`` preset at a (mesh, compression) point, with
    the reference's audit overrides."""
    from repro_torch.api import get_preset
    ov = dict(_SMOKE_OV)
    if mesh > 1:
        ov.update({"mesh.shape": (mesh,), "plan.microbatch": 4})
    ov.update({"compression.grads": grads, "compression.ring": ring,
               "compression.embed_store": embed_store})
    name = f"{arch}-smoke[mesh={mesh},grads={grads},ring={ring}" \
           f",store={embed_store}]"
    return get_preset(f"{arch}-smoke").override({**ov, "name": name})


def smoke_audit(mesh: int = 1, grads: str = "none", ring: str = "none",
                embed_store: str = "fp32", fused_serve: bool = True,
                arch: str = "lightgcn", device="cuda") -> list[str]:
    """The representative-preset audit: the ``{arch}-smoke`` preset at a
    (mesh, compression) point.  ``mesh > 1`` runs inside a process group
    of that many ranks.  The ngcf arch adds the fused-Hadamard contract:
    ``fusion_audit`` at mesh=1; at mesh>1 the ring owns aggregation, so
    the audit asserts the fused route fell back."""
    spec = smoke_spec(mesh, grads, ring, embed_store, arch)
    violations = audit_spec(spec, serve=fused_serve, device=device)
    if arch == "ngcf":
        if mesh <= 1:
            violations += fusion_audit(spec, where=spec.name, device=device)
        else:
            from repro_torch.api import build
            run = build(spec.override({"name": f"{spec.name}@ring-fallback"}),
                        device=device)
            if getattr(run.pipeline.g, "fused_hadamard", False):
                violations.append(
                    f"[{spec.name}] ring dispatch did not fall back to the "
                    "composed Hadamard route")
    return violations

"""End-to-end training launcher (the port of ``repro/launch/train.py``).

GNNRecSys archs (lightgcn / ngcf / gcn) run through the Experiment API
(``repro_torch.api``): every flag is a declarative-spec override, so the
CLI, a preset, and a JSON spec file all build the same ``ExperimentSpec``
as the reference's launcher for the same flags — the §7.1 large-batch
schedule, microbatched gradient accumulation, checkpoint resume and
streaming held-out eval ride along.  The run goes to the card unless
``--device cpu`` is given.

  python -m repro_torch.launch.train --preset quickstart
  python -m repro_torch.launch.train --device cpu --preset lightgcn-smoke
  python -m repro_torch.launch.train --arch ngcf --microbatch 512
  python -m repro_torch.launch.train --spec spec.json --set plan.microbatch=8

  python -m repro_torch.launch.train --device cpu --preset lightgcn-smoke \
      --microbatch 0 --memory-topology uniform --pin item_embed=slow \
      --embed-store int8 --compress-grads topk --compress-frac 0.1

``--microbatch 0`` derives the microbatch from the fast tier's headroom;
the planner's flags (``--memory-topology``, ``--placement-policy``,
``--pin``, and ``--set plan.hbm_budget=<bytes>`` as in the reference's
launcher) place the state on the tiers, and the compression flags
(``--compress-grads``, ``--compress-frac``, ``--embed-store``) compress
the gradients and the host-store tables.
Sharded execution (``--mesh``, ``--spmm``, ``--ring-steps``,
``--compress-ring``) runs one process per shard, each launched with the
same flags; ``torchrun`` opens the process group (gloo on the CPU, NCCL
on cards) and only rank 0 prints and writes checkpoints:

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --preset lightgcn-smoke --mesh 4

The legacy trainers (``train_gcn``, ``train_recsys``) run the
reference's synthetic data at the SMOKE configs under the same loop, on
the card unless ``--device cpu`` is given:

  python -m repro_torch.launch.train --arch gcn-cora --steps 50
  python -m repro_torch.launch.train --device cpu --arch deepfm --steps 20

The LM archs end as the reference's launcher ends them (``SystemExit``):
their entry points are ``repro_torch.models.transformer``'s ``train_step``,
``prefill`` and ``decode_step``.
Checkpoints default to ``<tempdir>/repro_ckpt/<arch>``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch.api import (DataCfg, Experiment, ExperimentSpec, LoopCfg,
                             ModelCfg, PlanCfg, get_preset)
from repro_torch.core.train_step import value_and_grad
from repro_torch.core.graph import from_numpy
from repro_torch.device import resolve_device, to_device
from repro_torch.models import gcn
from repro_torch.models import recsys_models as rm
from repro_torch.optim import adam
from repro_torch.pipeline.shard import parse_mesh
from repro_torch.runtime.loop import LoopConfig, run_training

PIPELINE_ARCHS = ("lightgcn", "ngcf", "gcn")

DEFAULT_CKPT_ROOT = os.path.join(tempfile.gettempdir(), "repro_ckpt")


def default_spec() -> ExperimentSpec:
    """The launcher's base spec — the values the flags override."""
    return ExperimentSpec(
        name="train",
        model=ModelCfg(arch="lightgcn", embed_dim=32, n_layers=2),
        data=DataCfg(source="synth", dataset="movielens-10m", edges=4000),
        plan=PlanCfg(base_batch=512, target_batch=2048, microbatch=512),
        loop=LoopCfg(steps=100),
    )


def build_arg_parser() -> argparse.ArgumentParser:
    """Flags default to None so only explicitly-passed ones override the
    base spec (preset / spec file / ``default_spec``)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="model architecture "
                    f"(pipeline: {', '.join(PIPELINE_ARCHS)}; plus the "
                    "legacy trainers: gcn-cora, deepfm, xdeepfm, dlrm_rm2)")
    ap.add_argument("--preset", help="start from a named spec "
                    "(repro_torch.api.preset_names())")
    ap.add_argument("--spec", help="start from a JSON ExperimentSpec file")
    ap.add_argument("--set", action="append", default=[], metavar="PATH=V",
                    help="dotted spec override, e.g. plan.hbm_budget=2048 "
                         "(repeatable; values parsed as JSON)")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--dataset", help="paper dataset statistics to "
                    "synthesize (repro_torch.data.synth.DATASET_STATS)")
    ap.add_argument("--edges", type=int)
    ap.add_argument("--target-batch", type=int,
                    help="large-batch target (accumulated microbatches)")
    ap.add_argument("--microbatch", type=int,
                    help="microbatch size; 0 = derive from HBM headroom")
    ap.add_argument("--embed-dim", type=int)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--eval-every", type=int,
                    help="held-out streaming-eval cadence in steps; "
                         "0 = final eval only")
    ap.add_argument("--eval-k", type=int)
    ap.add_argument("--mesh", help="mesh shape for sharded execution, "
                    "e.g. '4' or '2x2' (spec override mesh.shape); one "
                    "process per shard, e.g. under torchrun "
                    "--nproc-per-node 4")
    ap.add_argument("--ring-steps", type=int,
                    help="banded ring: visit only this many source owners "
                         "per SpMM (mesh.ring_steps; 0 = full ring)")
    ap.add_argument("--spmm", choices=["auto", "ring"],
                    help="aggregation dispatch (mesh.spmm); 'ring' forces "
                         "the ring route even on one device")
    ap.add_argument("--memory-topology",
                    help="registered TierTopology to model "
                         "(repro_torch.memory.topology_names(), e.g. "
                         "dram-optane-appdirect; spec override "
                         "memory.topology)")
    ap.add_argument("--placement-policy",
                    help="registered placement policy "
                         "(repro_torch.memory.policy_names(), e.g. "
                         "paper-recipe; "
                         "spec override memory.policy)")
    ap.add_argument("--pin", action="append", default=[],
                    metavar="TENSOR=TIER",
                    help="pin a tensor (by profile name or substring) to a "
                         "tier, e.g. --pin item_embed=slow (repeatable; "
                         "merges into memory.pins)")
    ap.add_argument("--compress-grads", choices=["none", "int8", "topk"],
                    help="compressed gradient combine (compression.grads): "
                         "int8 stochastic psum or top-k all-gather, with "
                         "error feedback")
    ap.add_argument("--compress-frac", type=float,
                    help="top-k kept fraction (compression.frac)")
    ap.add_argument("--embed-store", choices=["fp32", "int8"],
                    help="capacity-tier embedding-table storage "
                         "(compression.embed_store): int8 = ~1/4 bytes, "
                         "fp32 dequant-on-gather")
    ap.add_argument("--compress-ring", choices=["none", "int8"],
                    help="ring-SpMM payload rotation (compression.ring)")
    ap.add_argument("--device", default="cuda",
                    help="where the run goes: 'cuda' (the default; raises "
                         "without a card) or 'cpu' (the plain PyTorch "
                         "route)")
    return ap


def _parse_set(entry: str) -> tuple[str, object]:
    path, sep, raw = entry.partition("=")
    if not sep:
        raise SystemExit(f"--set expects PATH=VALUE, got {entry!r}")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw                       # bare strings pass through
    return path.strip(), value


def spec_from_args(args: argparse.Namespace) -> ExperimentSpec:
    """argparse namespace -> ExperimentSpec: base (spec file > preset >
    defaults), then flag overrides, then --set dotted overrides."""
    if args.spec:
        spec = ExperimentSpec.from_file(args.spec)
    elif args.preset:
        spec = get_preset(args.preset)
    else:
        spec = default_spec()
    ov: dict[str, object] = {}
    if args.arch is not None:
        ov["model.arch"] = args.arch
    if args.embed_dim is not None:
        ov["model.embed_dim"] = args.embed_dim
    if args.layers is not None:
        ov["model.n_layers"] = args.layers
    if args.dataset is not None:
        ov["data.dataset"] = args.dataset
    if args.edges is not None:
        ov["data.edges"] = args.edges
    if args.target_batch is not None:
        ov["plan.target_batch"] = args.target_batch
    if args.microbatch is not None:
        ov["plan.microbatch"] = args.microbatch or None
    if args.steps is not None:
        ov["loop.steps"] = args.steps
    if args.eval_every is not None:
        ov["loop.eval_every"] = args.eval_every or None
    if args.eval_k is not None:
        ov["eval.k"] = args.eval_k
    if args.mesh is not None:
        ov["mesh.shape"] = parse_mesh(args.mesh)
    if args.ring_steps is not None:
        ov["mesh.ring_steps"] = args.ring_steps or None
    if args.spmm is not None:
        ov["mesh.spmm"] = None if args.spmm == "auto" else args.spmm
    if args.memory_topology is not None:
        ov["memory.topology"] = args.memory_topology
    if args.placement_policy is not None:
        ov["memory.policy"] = args.placement_policy
    if args.compress_grads is not None:
        ov["compression.grads"] = args.compress_grads
    if args.compress_frac is not None:
        ov["compression.frac"] = args.compress_frac
    if args.embed_store is not None:
        ov["compression.embed_store"] = args.embed_store
    if args.compress_ring is not None:
        ov["compression.ring"] = args.compress_ring
    if args.pin:
        pins = dict(spec.memory.pins or {})
        for entry in args.pin:
            name, sep, tier = entry.partition("=")
            if not sep:
                raise SystemExit(f"--pin expects TENSOR=TIER, got {entry!r}")
            pins[name.strip()] = tier.strip()
        ov["memory.pins"] = pins
    spec = spec.override(ov)
    spec = spec.override(dict(_parse_set(s) for s in args.set))
    # ckpt-dir default last, so it names the arch the run actually uses
    # (a --set model.arch=... override included)
    if spec.loop.ckpt_dir is None:
        ckpt_root = args.ckpt_dir if args.ckpt_dir is not None \
            else DEFAULT_CKPT_ROOT
        spec = spec.override({"loop.ckpt_dir": f"{ckpt_root}/{spec.model.arch}"})
    return spec


def run_experiment(spec: ExperimentSpec, device="cuda"):
    """One spec, end to end on ``device``: build -> fit (fault-tolerant
    loop, resumes from the spec's checkpoint dir) -> final held-out
    streaming eval.  On a sharded run every rank runs this and rank 0
    prints."""
    run = Experiment(spec).build(device=device)
    pipe = run.pipeline
    say = print if pipe.is_writer else (lambda *a, **kw: None)
    say(run.describe())
    t0 = time.perf_counter()
    report = run.fit()
    dt = time.perf_counter() - t0
    say(f"[{spec.model.arch}] {report.steps_run} steps in {dt:.1f}s "
        f"loss {_loss_span(report)} "
        f"(microbatch={pipe.plan.microbatch}, "
        f"accum={pipe.plan.microbatches_for_epoch(pipe.consumed_epoch())}x, "
        f"resumed_from={report.resumed_from})")
    for step, m in report.eval_history:
        say(f"  eval@{step}: {_fmt_metrics(m)}")
    if run.holdout is not None:
        metrics = run.evaluate()
        say(f"[{spec.model.arch}] final held-out: {_fmt_metrics(metrics)}")
    return report


def _fmt_metrics(m: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))


def _loss_span(report) -> str:
    """'first -> last' loss, robust to a resume at max_steps (no new
    steps run -> losses is empty)."""
    if not report.losses:
        return "n/a (already at max_steps)"
    return f"{report.losses[0]:.4f} -> {report.losses[-1]:.4f}"


def gcn_train_step(cfg, g, x, labels, label_mask, opt):
    """``step(state) -> (state, loss)``: the full-graph ``gcn.loss_fn``,
    its gradients and one ``opt`` update of ``{"params", "opt"}``."""
    def step(state):
        loss, grads = value_and_grad(
            lambda p: gcn.loss_fn(cfg, p, g, x, labels, label_mask),
            state["params"])
        p, o = opt.update(grads, state["opt"], state["params"])
        return {"params": p, "opt": o}, loss

    return step


def train_gcn(steps: int, ckpt_dir: str, device="cuda", params=None):
    """The reference's legacy GCN trainer: gcn-cora SMOKE on a synthetic
    200-node, 1,600-edge graph with features and labels drawn from
    ``np.random.default_rng(0)`` (the reference's bytes), Adam 1e-2,
    checkpoints every ``steps // 2``.  ``params`` replaces the seeded init
    (e.g. the reference's, carried across by ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    cfg = config_registry.get("gcn_cora").SMOKE
    rng = np.random.default_rng(0)
    n = 200
    src = rng.integers(0, n, 1600).astype(np.int32)
    dst = rng.integers(0, n, 1600).astype(np.int32)
    g = from_numpy(src, dst, n, device=dev)
    x = to_device(rng.standard_normal((n, cfg.d_feat)).astype(np.float32),
                  dev)
    labels = to_device(rng.integers(0, cfg.n_classes, n).astype(np.int32),
                       dev)
    lmask = torch.ones((n,), dtype=torch.float32, device=dev)
    if params is None:
        params = gcn.init_params(cfg, 0, device=dev)
    opt = adam(1e-2)
    step = gcn_train_step(cfg, g, x, labels, lmask, opt)
    state0 = {"params": params, "opt": opt.init(params)}
    report = run_training(
        LoopConfig(ckpt_dir=ckpt_dir, ckpt_every=max(steps // 2, 1),
                   max_steps=steps, async_ckpt=False),
        state0, lambda s, _: step(s))
    print(f"[gcn] loss {_loss_span(report)}")
    return report


# (init, forward) of the CTR archs the legacy trainer runs
def _recsys_fns(arch: str):
    return {"deepfm": (rm.deepfm_init, rm.deepfm_forward),
            "xdeepfm": (rm.xdeepfm_init, rm.xdeepfm_forward),
            "dlrm_rm2": (rm.dlrm_init, rm.dlrm_forward)}[
                config_registry.canon(arch)]


def recsys_train_step(arch: str, cfg, opt):
    """``step(state, *feats, labels) -> (state, loss)``: the BCE of the
    arch's forward on ``feats`` (``ids``, or ``dense, ids`` for DLRM), its
    gradients w.r.t. every param (tables included) and one dense ``opt``
    update — the legacy trainer's step."""
    _, fwd = _recsys_fns(arch)

    def step(state, *args):
        *feats, labels = args
        loss, grads = value_and_grad(
            lambda p: rm.bce_loss(fwd(cfg, p, *feats), labels),
            state["params"])
        p, o = opt.update(grads, state["opt"], state["params"])
        return {"params": p, "opt": o}, loss

    return step


def dlrm_rowwise_step(cfg, opt):
    """``step(params, opt_state, dense, ids, labels) -> (params, opt_state,
    loss)``: DLRM's production step (the reference's
    ``launch/cells.py::_recsys_train_rowwise``): gradients w.r.t. the
    gathered rows and the MLPs, lazy row-wise AdaGrad (lr 0.01) IN PLACE
    on the tables and ``opt_state["acc"]``, ``opt`` on the MLPs.  ``opt_state``
    is ``{"acc": f32[F, V], "mlp": opt.init({"bot", "top"})}``."""
    def step(params, opt_state, dense, ids, labels):
        with torch.no_grad():
            emb = rm.lookup_fields(params["tables"], ids)
        mlps = {"bot": params["bot"], "top": params["top"]}
        loss, (g_emb, g_mlp) = value_and_grad(
            lambda t: rm.bce_loss(rm.dlrm_forward_from_emb(
                cfg, dict(params, **t[1]), dense, t[0]), labels),
            (emb, mlps))
        tables, acc = rm.rowwise_adagrad_update(
            params["tables"], opt_state["acc"], ids, g_emb)
        new_mlps, mlp_state = opt.update(g_mlp, opt_state["mlp"], mlps)
        return dict(params, tables=tables, **new_mlps), \
            {"acc": acc, "mlp": mlp_state}, loss

    return step


def train_recsys(arch: str, steps: int, ckpt_dir: str, batch: int = 256,
                 device="cuda", params=None):
    """The reference's legacy CTR trainer: deepfm, xdeepfm or dlrm_rm2 at
    SMOKE, Adam 1e-3, a fresh batch of ids, labels (and DLRM's dense
    features) a step from ``np.random.default_rng(0)`` in the reference's
    order, checkpoints every ``steps // 2``.  ``params`` replaces the
    seeded init (e.g. the reference's, carried across by
    ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    cfg = config_registry.get(arch).SMOKE
    rng = np.random.default_rng(0)
    init, _ = _recsys_fns(arch)
    if params is None:
        params = init(cfg, 0, device=dev)
    opt = adam(1e-3)
    is_dlrm = config_registry.canon(arch) == "dlrm_rm2"
    step = recsys_train_step(arch, cfg, opt)

    def step_fn(state, _):
        ids = to_device(rng.integers(0, cfg.vocab, (batch, cfg.n_sparse))
                        .astype(np.int32), dev)
        labels = to_device(rng.integers(0, 2, batch).astype(np.float32), dev)
        if is_dlrm:
            dense = to_device(rng.standard_normal((batch, cfg.n_dense))
                              .astype(np.float32), dev)
            return step(state, dense, ids, labels)
        return step(state, ids, labels)

    state0 = {"params": params, "opt": opt.init(params)}
    report = run_training(
        LoopConfig(ckpt_dir=ckpt_dir, ckpt_every=max(steps // 2, 1),
                   max_steps=steps, async_ckpt=False), state0, step_fn)
    print(f"[{arch}] loss {_loss_span(report)}")
    return report


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    if args.preset or args.spec or args.arch in PIPELINE_ARCHS:
        run_experiment(spec_from_args(args), device=args.device)
        return
    if args.arch is None:
        raise SystemExit("need --arch, --preset, or --spec")
    arch = config_registry.canon(args.arch)
    steps = args.steps if args.steps is not None else 100
    ckpt_root = args.ckpt_dir if args.ckpt_dir is not None \
        else DEFAULT_CKPT_ROOT
    if arch == "gcn_cora":
        train_gcn(steps, f"{ckpt_root}/{arch}", device=args.device)
    elif arch in ("deepfm", "xdeepfm", "dlrm_rm2"):
        train_recsys(arch, steps, f"{ckpt_root}/{arch}", device=args.device)
    else:
        raise SystemExit(
            f"CPU trainer for {arch!r} not wired; pipeline archs: "
            f"{', '.join(PIPELINE_ARCHS)}; also gcn-cora, deepfm, xdeepfm, "
            f"dlrm_rm2 (LM archs run via the dry-run: {dryrun_command(arch)})")


def dryrun_command(arch: str) -> str:
    """The dry-run's command line for ``arch``, its shapes listed."""
    shapes = [s for s in config_registry.get(arch).SHAPES
              if s not in config_registry.get(arch).SKIP]
    return (f"python -m repro_torch.launch.dryrun --arch {arch} --shape "
            f"<shape>, <shape> one of {', '.join(shapes)}")


if __name__ == "__main__":
    main()

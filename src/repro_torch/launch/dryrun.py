"""Dry-run: price every (architecture x input shape) cell on a mesh —
per-device argument bytes, a peak estimate, the roofline terms at H100
figures — without allocating a byte of it (the port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for a TPU mesh of 256 or 512
forced host devices and reads XLA's memory and cost analyses.  An eager
program has no compiled artifact, so here:

  * ``arg_bytes_per_dev`` is exact: each argument's shape under its spec
    (``shardings.per_device_bytes``, ceil division per sharded dim);
  * ``traced``: one pass of the cell's ``fn`` over its fake tensors
    under ``FlopCounterMode`` (matmul FLOPs), a count of every dispatched
    op's input and output bytes (the unfused bytes accessed), and
    ``MemTracker``'s peak of what the pass allocates; ``traced: false``
    with the reason where the cell is not traced (the LM cells, whose
    layer and tile loops the analytic model prices, as the reference
    does);
  * ``peak_bytes_per_dev``: the arguments' bytes on a device plus the
    pass's transients split evenly over the mesh; for LM cells the
    transients come from the memory model below (``peak_source`` names
    the model);
  * ``roofline``: ``launch/analytic.py::lm_cost`` for LM cells, the
    cell's own byte model where its meta has one (recsys trains, NGCF,
    the ring), else the traced FLOPs and bytes (collective bytes 0: one
    program on one card issues none).

The mesh is one of ``launch/mesh.py``'s ``MESHES``: ``one-card`` (the
default, this machine), ``pod`` and ``two-pods``, all analytic.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--archs a,b] [--mesh pod]
  python -m repro_torch.launch.dryrun --all --mesh all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs as config_registry
from repro_torch.launch import cells
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import MESHES
from repro_torch.launch.shardings import per_device_bytes
from repro_torch.optim.optimizers import tree_leaves, tree_map

HBM_PER_CHIP = rl.HBM_BYTES
LM_KINDS = ("train", "prefill", "decode")


# ------------------------------------------------------------ LM memory model

def lm_param_bytes(cfg) -> int:
    """The params' bytes in bfloat16, the router in float32."""
    router = cfg.n_layers * cfg.d_model * cfg.n_experts
    return 2 * cfg.param_count() + 2 * router


def lm_cache_bytes(cfg, batch: int, seq: int) -> int:
    return 2 * cfg.n_layers * batch * cfg.n_kv_heads * seq * cfg.head_dim * 2


def lm_act_bytes(cfg, rows: int, seq: int, train: bool) -> float:
    """A pass's transient bytes at [rows, seq]: one layer's FFN hidden
    (bf16 and float32 copies, 12 bytes a column; a MoE token's k slots at
    the capacity factor, its dispatched rows and combined outputs),
    attention (4 tiles of TILE_BYTES; when training, one layer's saved
    float32 scores on the re-forward, 4 copies of [rows, H, seq, seq]),
    when training the float32 logits (5 copies: the softcap's and
    logsumexp's saved tensors and gradients) and the checkpointed layer
    inputs, and a few [t, D] activations."""
    from repro_torch.models.attention import TILE_BYTES
    t = rows * seq
    if cfg.is_moe:
        width = (cfg.top_k * cfg.capacity_factor + cfg.shared_experts) \
            * cfg.moe_d_ff
        moe = 4 * t * cfg.top_k * cfg.d_model * 2
    else:
        width, moe = cfg.d_ff, 0
    act = t * width * 12 + moe + 8 * t * cfg.d_model * 2
    if not train:
        return act + 4 * TILE_BYTES
    return act + 4 * rows * cfg.n_heads * seq * seq * 4 \
        + 5 * t * cfg.vocab * 4 + cfg.n_layers * t * cfg.d_model * 2


def lm_train_need(cfg, train, seq: int) -> float:
    """Peak bytes of ``train``'s steps (global batch, microbatches, steps,
    optimizer, lr, seq) from bf16 params, by the dtypes the optimizers
    give: Adam turns the params float32 at step 1 and the moments to the
    gradients' dtype (float32 when accumulated, or when the params are);
    adafactor keeps them.  The larger of a microbatch's backward (state,
    accumulator, its gradients, a second copy of the stacked layers' and
    of one table's, activations) and an update (old state, gradients, new
    state, 1 GiB of pieces)."""
    gb, micro, steps, opt_name, _, _ = train
    n = lm_param_bytes(cfg) / 2
    table = cfg.vocab * cfg.d_model
    stacked = n - 2 * table                          # the [L, ...] leaves
    act = lm_act_bytes(cfg, gb // micro, seq, True)
    if opt_name == "adafactor":
        return max(4 * n + 2 * (stacked + table) + act, 6 * n + (1 << 30))
    p, mv, back, upd = 2, 2, 0.0, 0.0
    for _ in range(steps):
        g = 4 if micro > 1 or p == 4 else 2
        back = max(back, (p + 2 * mv + (4 if micro > 1 else 0) + g) * n
                   + g * (stacked + table))
        new_mv = max(mv, g)
        upd = max(upd, p + 2 * mv + g + 4 + 2 * new_mv)
        p, mv = 4, new_mv
    return max(back + act, upd * n + (1 << 30))


def lm_cell_need(kind: str, cfg, shape: dict, optimizer: str) -> float:
    """One card's peak bytes for an LM cell at its own shape: one train
    step, or the params with a prefill's or a decode step's cache and
    activations."""
    b, s = shape["global_batch"], shape["seq_len"]
    if kind == "train":
        mb = shape.get("microbatches", 1)
        return lm_train_need(cfg, (b, mb, 1, optimizer, None, s), s)
    rows_seq = (b, s) if kind == "prefill" else (b, 1)
    return lm_param_bytes(cfg) + lm_cache_bytes(cfg, b, s) \
        + lm_act_bytes(cfg, *rows_seq, False)


# ------------------------------------------------------------------ tracing

class _Traffic(TorchDispatchMode):
    """Bytes accessed, unfused: every dispatched op's tensor inputs read
    once and its outputs written once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.bytes += _nbytes(t for t in tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def trace_cell(cell) -> dict:
    """One pass of ``cell.fn`` over its fake args: matmul FLOPs, bytes
    accessed and the peak of the bytes the pass allocates."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    traffic, mem = _Traffic(), MemTracker()
    args = tree_leaves(list(cell.args))
    # the args are tracked from the start, so a view of one (an in-place
    # update's) is not taken for a new allocation
    mem.track_external(*args)
    t0 = time.perf_counter()
    with cell.fake_mode, mem, FlopCounterMode(display=False) as flops, \
            traffic:
        cell.fn(*cell.args)
    peak = max(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(traffic.bytes),
            "transient_peak_bytes": int(peak - _nbytes(args)),
            "trace_s": time.perf_counter() - t0}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def arg_bytes_per_device(cell, mesh) -> int:
    out = []
    tree_map(lambda t, s: out.append(per_device_bytes(t.shape, t.dtype, s,
                                                      mesh)),
             list(cell.args), list(cell.in_specs))
    return sum(out)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


# ------------------------------------------------------------------ cells

def run_cell(arch: str, shape: str, mesh: str = "one-card",
             verbose: bool = True) -> dict:
    m = MESHES[mesh]
    n_chips = m.size
    arch = config_registry.canon(arch)
    mod = config_registry.get(arch)
    t0 = time.perf_counter()
    cell = cells.build_cell(arch, shape, m)
    build_s = time.perf_counter() - t0
    if not all(_is_fake(t) for t in tree_leaves(list(cell.args))):
        raise RuntimeError(f"{arch}/{shape}: a cell argument has storage")
    arg_bytes = arg_bytes_per_device(cell, m)
    whole_args = _nbytes(tree_leaves(list(cell.args)))
    analytic_cost = None
    traced: dict | bool = False
    if cell.kind in LM_KINDS:
        from repro_torch.launch.analytic import lm_cost
        analytic_cost = lm_cost(cell.kind, mod.FULL, mod.SHAPES[shape], m)
        need = lm_cell_need(cell.kind, mod.FULL, mod.SHAPES[shape],
                            mod.OPTIMIZER)
        transient = max(0.0, need - whole_args)
        peak_source = "lm_memory_model"
        untraced = ("LM cell: launch/analytic.py prices it; a fake pass of "
                    "the layer and tile loops is slow")
        peak_dtype = mod.FULL.dtype
    else:
        traced = trace_cell(cell)
        transient = traced["transient_peak_bytes"]
        peak_source = "mem_tracker"
        untraced = None
        peak_dtype = "float32"
        if "ring_coll_bytes" in cell.meta:
            # the ring's bytes are the rotation schedule's, not one pass's
            analytic_cost = dict(flops=cell.meta["model_flops"],
                                 hbm_bytes=cell.meta["ring_hbm_bytes"],
                                 coll_bytes=cell.meta["ring_coll_bytes"])
        elif "analytic_hbm" in cell.meta:
            # dense-optimizer table streaming and the [E, D] message
            # stream: the cell's documented byte model
            analytic_cost = dict(flops=cell.meta["model_flops"],
                                 hbm_bytes=cell.meta["analytic_hbm"],
                                 coll_bytes=cell.meta["analytic_coll"])
    if analytic_cost is not None:
        terms = (analytic_cost["flops"], analytic_cost["hbm_bytes"],
                 analytic_cost["coll_bytes"])
    else:
        terms = (traced["flops"], traced["bytes_accessed"], 0.0)
    roof = rl.analyze(*terms, n_chips,
                      model_flops=cell.meta.get("model_flops", 0.0),
                      peak_flops=rl.PEAK_FLOPS[peak_dtype])
    peak = arg_bytes + transient / n_chips
    rec = {
        "arch": arch, "shape": shape, "kind": cell.kind, "mesh": mesh,
        "chips": n_chips,
        "build_s": round(build_s, 3),
        "arg_bytes_per_dev": arg_bytes,
        "transient_bytes_per_dev": transient / n_chips,
        "peak_bytes_per_dev": peak,
        "peak_source": peak_source,
        "fits_hbm": bool(peak <= HBM_PER_CHIP),
        "roofline": roof.as_dict(),
        "analytic": analytic_cost,
        "traced": traced if traced else False,
        "meta": cell.meta,
    }
    if untraced:
        rec["traced_reason"] = untraced
    if verbose:
        print(f"[{arch}/{shape}/{mesh}] args/dev={arg_bytes / 1e9:.3f} GB "
              f"peak/dev={peak / 1e9:.3f} GB ({peak_source}) "
              f"fits={rec['fits_hbm']} bottleneck={roof.bottleneck} "
              f"terms(c/m/coll)={roof.compute_s:.4g}/{roof.memory_s:.4g}/"
              f"{roof.collective_s:.4g}s", flush=True)
    return rec


def all_cells(archs=None):
    """(arch, shape) of every cell, and (arch, shape, reason) of every
    skipped one."""
    ids, skips = [], []
    for arch in archs or config_registry.ARCH_IDS:
        mod = config_registry.get(arch)
        ids += [(config_registry.canon(arch), s) for s in mod.SHAPES
                if s not in mod.SKIP]
        skips += [(config_registry.canon(arch), s, r)
                  for s, r in mod.SKIP.items()]
    return ids, skips


def _save(out_dir, rec):
    tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="one-card",
                    choices=list(MESHES) + ["all"])
    ap.add_argument("--out", type=str, default="results/dryrun_torch")
    ap.add_argument("--archs", type=str, default=None,
                    help="comma-separated subset for --all")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        for mesh in meshes:
            _save(args.out, run_cell(args.arch, args.shape, mesh))
        return 0

    ids, skips = all_cells(args.archs.split(",") if args.archs else None)
    failures = []
    for arch, shape in ids:
        for mesh in meshes:
            try:
                _save(args.out, run_cell(arch, shape, mesh))
            except Exception as e:  # noqa: BLE001 — report every cell
                traceback.print_exc()
                failures.append((f"{arch}/{shape}/{mesh}", str(e)))
    for arch, shape, reason in skips:
        print(f"SKIP {arch}/{shape}: {reason}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        return 1
    print(f"\nall {len(ids)} dry-run cells x {len(meshes)} mesh(es) OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

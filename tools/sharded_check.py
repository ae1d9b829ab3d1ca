"""Sharded training across the cards of one host, against one card.

    torchrun --standalone --nproc-per-node 4 tools/sharded_check.py
    # a rehearsal on the CPU (gloo ranks, the smoke preset's own data):
    torchrun --standalone --nproc-per-node 4 tools/sharded_check.py \
        --device cpu --preset lightgcn-smoke

Every rank builds the same graph (LightGCN FULL's 349,184 users x 53,248
items with 2^--edges-log2 requested edges, or the preset's own data when
it is not ``lightgcn-full``), then runs the preset for --steps steps
twice: sharded over the P ranks (``mesh.shape = (P,)``: row-sharded
tables, the ring SpMM over the process group) and, on its own device,
unsharded (the kernel route).  Rank 0 holds the sharded losses to the
unsharded ones within the reference's sharded tolerance (rtol 5e-3, atol
1e-5) and prints one JSON line: per-step ms of both runs (host clock
around synchronised steps), the ring's rotations and payload bytes per
call, each rank's allocated device memory after the runs' steps, and the
card's name.  Exits non-zero on a failed check.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS = 349_184, 53_248
RTOL, ATOL = 5e-3, 1e-5


def _data(preset: str, edges_log2: int):
    from repro_torch.api import get_preset, load_data
    from repro_torch.data import synth
    if preset != "lightgcn-full":
        return load_data(get_preset(preset).data)
    data = synth.generate_bipartite(N_USERS, N_ITEMS, 1 << edges_log2,
                                    seed=0)
    return synth.train_test_split(data, 0.1, seed=0)


def _fit(torch, dev, preset, overrides, train, steps):
    """(losses, ms per step, allocated bytes after the steps, run)."""
    from repro_torch.api import Experiment
    run = Experiment.from_preset(preset, {"loop.steps": 1, **overrides}) \
        .build(train=train, device=dev)
    ms, losses = [], []
    for _ in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(run.step())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    mem = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    return losses, ms, mem, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="lightgcn-full")
    ap.add_argument("--edges-log2", type=int, default=22)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("run under torchrun, one process per shard")
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    train, _ = _data(args.preset, args.edges_log2)
    # the same global batch: a preset's fixed microbatch is split over the
    # shards (a derived one already is); the sharded run opens the group
    # from torchrun's environment
    from repro_torch.api import get_preset
    sharded = {"mesh.shape": [world], "mesh.spmm": "ring"}
    micro = get_preset(args.preset).plan.microbatch
    if micro is not None:
        sharded["plan.microbatch"] = micro // world
    sh_losses, sh_ms, sh_mem, run = _fit(torch, dev, args.preset, sharded,
                                         train, args.steps)
    ring = run.pipeline.g._ring.ring("sym")
    per_call = (ring.rotations, ring.payload_bytes)
    calls = max(1, args.steps * 2 * run.spec.model.n_layers)
    shards = run.pipeline.plan.shards
    del run
    un_losses, un_ms, un_mem, _ = _fit(torch, dev, args.preset, {}, train,
                                       args.steps)
    mems = [None] * world
    dist.all_gather_object(mems, sh_mem)
    rank = dist.get_rank()
    ok = shards == world and all(
        abs(a - b) <= ATOL + RTOL * abs(b)
        for a, b in zip(sh_losses, un_losses))
    if rank == 0:
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        print(json.dumps({
            "sharded_check": {"device": kind, "ranks": world,
                              "preset": args.preset,
                              "train_edges": int(train.n_edges),
                              "steps": args.steps,
                              "sharded_losses": sh_losses,
                              "unsharded_losses": un_losses,
                              "sharded_ms": sh_ms, "unsharded_ms": un_ms,
                              "ring_rotations_per_call":
                                  per_call[0] / calls,
                              "ring_payload_bytes_per_call":
                                  per_call[1] / calls,
                              "allocated_sharded_per_rank": mems,
                              "allocated_unsharded_rank0": un_mem,
                              "tolerance": {"rtol": RTOL, "atol": ATOL},
                              "ok": bool(ok)}}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if not ok:
        print(f"rank {rank}: sharded losses {sh_losses} off {un_losses}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A/B of the port's row-split ``hadamard_spmm`` and register-blocked
``fused_topk_score`` against the versions of a parent checkout (one warp
per destination row; 16 x 64 score tiles of 4 x 1 per thread), on one
card, in one process.

    python3 tools/torch_kernel_ab.py --parent DIR

DIR holds an unpacked parent commit (``git archive``) whose kernels take
the C interfaces of the one-warp-per-row ``hadamard_spmm`` and the
16-user-tile ``fused_topk_score``.  Both versions are built with the
same nvcc flags and run on the same inputs, in the order parent, change,
change, parent:
  * ``hadamard_spmm`` (no epilogue) at NGCF's forward shapes on a
    synthetic graph with the smoke's counts (``synthetic_graph``: 349,184
    users, 53,248 items, D = 128, 15,084,083 edges; item degrees
    Zipf(0.75) by rank, so the longest item row holds ~1.7 % of E, as in
    the smoke's graph; users uniform): the item direction
    (``hadamard_agg_item``, 53,248 rows) and the user direction
    (``hadamard_agg_user``, 349,184 rows), y riding the destination; ms
    per call, CUDA events around 3 calls;
  * ``fused_topk_score``: a 256-user batch against 53,248 items, D = 128,
    ~43 seen items per user, at k = 20 and at k = 256 (the parent's
    largest k); ms per call, CUDA events around 20 calls.
Each version is first held to the plain version on the same inputs.
Prints one JSON line per measurement and a summary line last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N_USERS, N_ITEMS, EDGES, D, ZIPF = 349_184, 53_248, 15_084_083, 128, 0.75
TOPK_B, TOPK_KS, SEEN_LEN = 256, (20, 256), 100
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the parent's fused_topk_score tiles (its kernels/topk_score.py)
PARENT_USER_TILE, PARENT_ITEM_TILE = 16, 64


def synthetic_graph(torch, dev, seed: int = 0) -> dict:
    """Both CSR directions of a graph with the smoke's counts on ``dev``:
    item degrees Zipf(ZIPF) by rank, each edge's user uniform.  Keys
    ``ui_indptr``/``ui_src``/``ui_dst`` (rows = items, src = users) and
    ``iu_*`` (rows = users, src = items); indptr i64, ids i32."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, N_ITEMS + 1, dtype=np.float64) ** -ZIPF
    deg = np.floor(EDGES * w / w.sum()).astype(np.int64)
    deg[: EDGES - int(deg.sum())] += 1
    ui_indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])).to(dev)
    ui_dst = torch.repeat_interleave(
        torch.arange(N_ITEMS, dtype=torch.int32, device=dev),
        torch.from_numpy(deg).to(dev))
    ui_src = torch.from_numpy(rng.integers(0, N_USERS, EDGES)
                              .astype(np.int32)).to(dev)
    order = torch.sort(ui_src, stable=True).indices
    iu_deg = torch.bincount(ui_src.long(), minlength=N_USERS)
    iu_indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(iu_deg, 0)])
    return {"ui_indptr": ui_indptr, "ui_src": ui_src, "ui_dst": ui_dst,
            "iu_indptr": iu_indptr, "iu_src": ui_dst[order].contiguous(),
            "iu_dst": ui_src[order].contiguous(),
            "longest_item_row": int(deg.max())}


def build_parent(parent: pathlib.Path) -> dict:
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for name in ("hadamard_spmm", "topk_score"):
        src = parent / "src/repro_torch/kernels/csrc" / f"{name}.cu"
        so = out_dir / f"parent_{name}.so"
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)])))
    for name, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu")
        libs[name] = ctypes.CDLL(str(so))
    libs["hadamard_spmm"].hadamard_spmm_f32.argtypes = \
        [_P] * 6 + [_I, _F, _P] + [_I] * 4 + [_P]
    libs["topk_score"].fused_topk_score_f32.argtypes = \
        [_P] * 9 + [_I, _I, _L] + [_I] * 6 + [_P]
    return libs


def events_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def turns(torch, parent_fn, change_fn, reps: int) -> dict:
    """ms per call in the order parent, change, change, parent."""
    times = {"parent_ms": [], "change_ms": []}
    for who in ("parent", "change", "change", "parent"):
        fn = parent_fn if who == "parent" else change_fn
        times[f"{who}_ms"].append(events_ms(torch, fn, reps))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    parent = ap.parse_args().parent.resolve()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = build_parent(parent)
    _build.build_all(("hadamard_spmm", "topk_score"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    rows = {}

    # hadamard_spmm: NGCF's forward pair, y riding the destination
    g = synthetic_graph(torch, dev)
    xu = torch.from_numpy(rng.standard_normal((N_USERS, D))
                          .astype(np.float32)).to(dev)
    xi = torch.from_numpy(rng.standard_normal((N_ITEMS, D))
                          .astype(np.float32)).to(dev)
    calls = {"hadamard_agg_item": (xu, xi, g["ui_indptr"], g["ui_src"],
                                   g["ui_dst"], N_ITEMS),
             "hadamard_agg_user": (xi, xu, g["iu_indptr"], g["iu_src"],
                                   g["iu_dst"], N_USERS)}
    for name, args in calls.items():
        x, y, ip, xi_, yi_, n = args

        def had_parent(x=x, y=y, ip=ip, xi_=xi_, yi_=yi_, n=n):
            out = torch.empty((n, D), device=dev)
            err = libs["hadamard_spmm"].hadamard_spmm_f32(
                x.data_ptr(), y.data_ptr(), ip.data_ptr(), xi_.data_ptr(),
                yi_.data_ptr(), None, 0, 0.0, out.data_ptr(), n, D, 1, 0,
                stream)
            if err:
                raise RuntimeError(f"parent hadamard_spmm: CUDA error {err}")
            return out

        def had_change(args=args):
            return ops.hadamard_spmm(*args, impl="cuda")

        want = ref.hadamard_spmm_ref(*args)
        abs_sum = ref.hadamard_spmm_ref(x.abs(), y.abs(), ip, xi_, yi_, n)
        for fn, what in ((had_parent, "parent"), (had_change, "change")):
            if not bool(((fn() - want).abs() <= 1e-5 + 1e-5 * abs_sum).all()):
                raise RuntimeError(f"hadamard_spmm {what} disagrees with the "
                                   "plain version")
        del want, abs_sum
        rows[name] = {"work": f"{n} rows, {xi_.numel()} edges, D={D}, "
                              f"longest item row {g['longest_item_row']}",
                      **turns(torch, had_parent, had_change, reps=3)}
        print(json.dumps({"kernel": "hadamard_spmm", "call": name,
                          **rows[name]}), flush=True)
    del g, calls, xu, xi
    torch.cuda.empty_cache()

    # fused_topk_score: one 256-user batch against the whole catalogue
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ue = torch.from_numpy(rng.standard_normal((TOPK_B, D))
                          .astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.standard_normal((N_ITEMS, D))
                             .astype(np.float32)).to(dev)
    seen = torch.from_numpy(rng.integers(0, N_ITEMS, (TOPK_B, SEEN_LEN))
                            .astype(np.int32)).to(dev)
    smask = torch.from_numpy(rng.random((TOPK_B, SEEN_LEN)) < 0.43).to(dev)
    n_tiles = math.ceil(N_ITEMS / PARENT_ITEM_TILE)
    splits = max(1, min(n_tiles, 65_535, math.ceil(
        2 * sms / math.ceil(TOPK_B / PARENT_USER_TILE))))
    per = math.ceil(n_tiles / splits)
    splits = math.ceil(n_tiles / per)
    for k in TOPK_KS:
        part_s = torch.empty((splits, TOPK_B, k), device=dev)
        part_i = torch.empty((splits, TOPK_B, k), dtype=torch.int32,
                             device=dev)
        bits = torch.empty((TOPK_B, math.ceil(N_ITEMS / 32)),
                           dtype=torch.int32, device=dev)

        def topk_parent(k=k, part_s=part_s, part_i=part_i, bits=bits):
            out_s = torch.empty((TOPK_B, k), device=dev)
            out_i = torch.empty((TOPK_B, k), dtype=torch.int32, device=dev)
            err = libs["topk_score"].fused_topk_score_f32(
                ue.data_ptr(), table.data_ptr(), seen.data_ptr(),
                smask.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                part_s.data_ptr(), part_i.data_ptr(), bits.data_ptr(),
                TOPK_B, D, N_ITEMS, N_ITEMS, SEEN_LEN, k, per, splits, 0,
                stream)
            if err:
                raise RuntimeError(f"parent fused_topk_score: error {err}")
            return out_s, out_i

        def topk_change(k=k):
            return ops.fused_topk_score(ue, table, seen, smask, k=k,
                                        n_items=N_ITEMS, impl="cuda")

        s_p, i_p = ref.fused_topk_score_ref(ue, table, seen, smask, k=k,
                                            n_items=N_ITEMS, item_block=1024)
        for fn, what in ((topk_parent, "parent"), (topk_change, "change")):
            s_k, i_k = fn()
            chip_smoke.topk_agree(s_k.cpu(), i_k.cpu(), s_p.cpu(), i_p.cpu(),
                                  f"fused_topk_score k={k} {what}")
        key = f"fused_topk_score k={k}"
        rows[key] = {"work": f"B={TOPK_B} I={N_ITEMS} D={D} k={k}",
                     **turns(torch, topk_parent, topk_change, reps=20)}
        print(json.dumps({"kernel": "fused_topk_score", "k": k,
                          **rows[key]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ab": {k: {"parent_ms": min(v["parent_ms"]),
                                 "change_ms": min(v["change_ms"])}
                             for k, v in rows.items()}, "card": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A/B of one of the port's kernels against a parent checkout, on one card,
in one process.

    python3 tools/torch_kernel_ab.py --parent DIR [--kernel sddmm]
        [--variants 128-4-1,...]
    python3 tools/torch_kernel_ab.py --parent DIR --kernel embedding_bag
        [--turns PCCP]
    python3 tools/torch_kernel_ab.py --parent DIR --kernel fused_topk_score
        [--turns PCCP]

DIR holds an unpacked parent commit (``git archive``).

``--kernel embedding_bag``: the parent's wrapper, library and
``eval/topk.py::_gather_rows`` run as the parent's own source (loaded from
DIR under other module names), beside the change's.  Bit equality of the
change (int32 and int64 ids, with a mask and without) with the parent and
the plain version, for sum and mean at L = 1 and L = 8; then, in the
order of ``--turns`` (P parent, C change), at the serving shape (256
bags of one of 349,184 rows, D = 128): host µs per wrapper call and per
``_gather_rows`` with int32 and int64 ids (10,000 calls on a host clock),
device µs (100 calls in a CUDA graph), µs between CUDA events, and each
piece of the wrapper's host path (the checks, the allocation, the stream
query, the C call with its launch), 10,000 calls each.

``--kernel fused_topk_score``: the parent's ``topk_score.cu`` (the same C
interface) built beside the change's and called with the same arguments.
At the serving shape (256 users of D = 128 against 53,248 items, k = 20,
64 seen slots a user, half of them live): the parent, the change and the
plain version give the same ids and score bits on finite scores; on
``chip_smoke.py``'s ``nan_inf`` case the change equals the plain version
bit for bit (the parent's is reported); then ms per call (CUDA events
around 50 calls) in the order of ``--turns``.

``--kernel sddmm`` (the default) needs a parent whose ``sddmm_f32`` takes
the edge-order C interface (op, x, y, src, dst, mask, coeff, out, E, D,
vec4, device, stream), the kernel before it walked user groups.  The
graph has the smoke's counts (349,184 users, 53,248 items, 15,084,083
edges, D = 128) and is drawn on the card
as ``synth.generate_bipartite`` draws it: users and items Zipf(1.05),
duplicate pairs dropped and drawn again until there are enough, both id
spaces permuted; its
edges lie in random order, as ``train_test_split`` leaves them.  The
call is NGCF's O3 message, x the user table and y the item table, with
~0.1 % of the edges masked.  Then:
  * the parent, the change with the graph's user groups and the change
    without groups give the same output bit for bit, for ``mul``,
    ``add``, ``dot`` and ``copy`` (with coeff);
  * ``mul`` and ``dot`` are timed in the order parent, change, change,
    parent (ms per call, CUDA events around 10 calls), and the change
    without groups once;
  * each variant C-U-B of ``--variants`` (the source built with
    ``-DREPRO_SDDMM_CHUNK=C -DREPRO_SDDMM_UNROLL=U
    -DREPRO_SDDMM_MIN_BLOCKS=B``) is held bitwise to the parent and timed
    twice on ``mul`` and ``dot``;
  * the groups' build (one stable sort and three gathers) is timed once;
  * two write yardsticks on the [E, D] output: ``fill_`` (every row
    written once, in edge order) and ``index_fill_`` by the groups' perm
    (every row written once, in the grouped walk's order), so that the
    cost of the walk's scattered row stores shows apart from its loads;
  * the change on two re-arranged inputs, to show where its time goes:
    the same edges sorted by user (the walk's perm is then the identity,
    so its row stores run in order) and the same edges with every item
    id folded onto 1,024 rows (a 512 KB item table, L2-resident however
    much the output streams past it).
Both versions are built with the same nvcc flags.  Prints one JSON line
per measurement, the card's name and power limit, and a summary last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N_USERS, N_ITEMS, EDGES, D, ALPHA = 349_184, 53_248, 15_084_083, 128, 1.05
MASKED = 0.001
OPS = ("mul", "add", "dot", "copy")
TIMED = ("mul", "dot")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_ARGS = [_I] + [_P] * 7 + [_L, _I, _I, _I, _P]
CHANGE_ARGS = [_I] + [_P] * 8 + [_L, _I, _I, _I, _P]


def synthetic_edges(torch, dev, seed: int = 0):
    """(user, item) i32[EDGES] on ``dev``, in random order."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def zipf(n):
        p = torch.arange(1, n + 1, device=dev, dtype=torch.float64) ** -ALPHA
        return (p / p.sum()).float()

    pu, pi = zipf(N_USERS), zipf(N_ITEMS)
    keys = torch.zeros(0, dtype=torch.int64, device=dev)
    while keys.numel() < EDGES:
        m = int((EDGES - keys.numel()) * 1.5) + 1024
        u = torch.multinomial(pu, m, replacement=True, generator=gen)
        i = torch.multinomial(pi, m, replacement=True, generator=gen)
        keys = torch.unique(torch.cat([keys, u * N_ITEMS + i]))
    order = torch.randperm(keys.numel(), device=dev, generator=gen)
    keys = keys[order[:EDGES]]
    uperm = torch.randperm(N_USERS, device=dev, generator=gen)
    iperm = torch.randperm(N_ITEMS, device=dev, generator=gen)
    user = uperm[keys // N_ITEMS].to(torch.int32).contiguous()
    item = iperm[keys % N_ITEMS].to(torch.int32).contiguous()
    return user, item


def build(parent: pathlib.Path, variants) -> dict:
    """The parent's library and one per variant, all nvcc at once."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"parent": (parent / "src/repro_torch/kernels/csrc/sddmm.cu", [])}
    for c, u, b in variants:
        jobs[f"{c}-{u}-{b}"] = (_build.CSRC / "sddmm.cu",
                                [f"-DREPRO_SDDMM_CHUNK={c}",
                                 f"-DREPRO_SDDMM_UNROLL={u}",
                                 f"-DREPRO_SDDMM_MIN_BLOCKS={b}"])
    procs = {}
    for name, (src, defs) in jobs.items():
        so = out_dir / f"sddmm_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-o", str(so),
             str(src)]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on sddmm {name}")
        lib = ctypes.CDLL(str(so))
        lib.sddmm_f32.argtypes = PARENT_ARGS if name == "parent" \
            else CHANGE_ARGS
        lib.sddmm_f32.restype = _I
        libs[name] = lib
    return libs


def events_ms(torch, fn, reps: int = 10) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--kernel", choices=("sddmm", "embedding_bag",
                                         "fused_topk_score"),
                    default="sddmm")
    ap.add_argument("--variants", default="",
                    help="sddmm: comma-separated C-U-B: chunk, unroll, min "
                         "blocks per SM")
    ap.add_argument("--turns", default="PCCP",
                    help="embedding_bag, fused_topk_score: the order of "
                         "the timed turns, P for the parent and C for the "
                         "change")
    args = ap.parse_args()
    if args.kernel == "embedding_bag":
        return main_embedding_bag(args)
    if args.kernel == "fused_topk_score":
        return main_topk(args)
    return main_sddmm(args)


def main_sddmm(args) -> int:
    variants = [tuple(int(v) for v in s.split("-"))
                for s in args.variants.split(",") if s]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.sddmm import OP_CODES, group_edges
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = build(args.parent.resolve(), variants)
    _build.build_all(("sddmm",))
    stream = torch.cuda.current_stream(dev).cuda_stream

    user, item = synthetic_edges(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    xu = torch.randn((N_USERS, D), device=dev, generator=gen)
    xi = torch.randn((N_ITEMS, D), device=dev, generator=gen)
    coeff = torch.randn(EDGES, device=dev, generator=gen)
    mask = torch.rand(EDGES, device=dev, generator=gen) >= MASKED
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = group_edges(user, item, mask)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    deg = torch.bincount(user.long(), minlength=N_USERS)
    graph = {"edges": EDGES, "users": N_USERS, "items": N_ITEMS, "d": D,
             "largest_user_group": int(deg.max()),
             "largest_item_degree": int(torch.bincount(item.long()).max()),
             "users_with_edges": int((deg > 0).sum()),
             "groups_build_ms": build_ms}
    print(json.dumps({"graph": graph}), flush=True)

    outs = {op: torch.empty((EDGES,) if op == "dot" else (EDGES, D),
                            device=dev) for op in OPS}

    def parent(op):
        err = libs["parent"].sddmm_f32(
            OP_CODES[op], xu.data_ptr(), xi.data_ptr(), user.data_ptr(),
            item.data_ptr(), mask.data_ptr(),
            coeff.data_ptr() if op == "copy" else None,
            outs[op].data_ptr(), EDGES, D, 1, 0, stream)
        if err:
            raise RuntimeError(f"parent sddmm {op}: CUDA error {err}")
        return outs[op]

    def variant(name, op):
        err = libs[name].sddmm_f32(
            OP_CODES[op], xu.data_ptr(), xi.data_ptr(),
            groups.perm.data_ptr(), groups.key_sorted.data_ptr(),
            groups.other_sorted.data_ptr(), groups.mask_sorted.data_ptr(),
            coeff.data_ptr() if op == "copy" else None,
            outs[op].data_ptr(), EDGES, D, 1, 0, stream)
        if err:
            raise RuntimeError(f"sddmm {name} {op}: CUDA error {err}")
        return outs[op]

    def change(op, grouped=True):
        return ops.sddmm(op, xu, xi, user, item, mask,
                         coeff if op == "copy" else None, impl="cuda",
                         groups=groups if grouped else None)

    for op in OPS:
        want = parent(op).clone()
        same = {"change": torch.equal(change(op), want),
                "change_without_groups": torch.equal(change(op, False), want)}
        for v in variants:
            name = "-".join(map(str, v))
            same[name] = torch.equal(variant(name, op), want)
        del want
        print(json.dumps({"op": op, "bitwise_equal_to_parent": same}),
              flush=True)
        if not all(same.values()):
            raise RuntimeError(f"sddmm {op}: not bitwise equal to the parent")
    rows = {}
    for op in TIMED:
        times = {"parent_ms": [], "change_ms": []}
        for who in ("parent", "change", "change", "parent"):
            fn = (lambda: parent(op)) if who == "parent" \
                else (lambda: change(op))
            times[f"{who}_ms"].append(events_ms(torch, fn))
        times["change_without_groups_ms"] = events_ms(
            torch, lambda: change(op, False))
        for v in variants:
            name = "-".join(map(str, v))
            times[f"chunk-unroll-minblocks {name} ms"] = [
                events_ms(torch, lambda: variant(name, op)) for _ in range(2)]
        rows[op] = times
        print(json.dumps({"kernel": "sddmm", "op": op,
                          "work": f"E={EDGES} D={D}, x users, y items",
                          **times}), flush=True)
    out, perm = outs["mul"], groups.perm.long()
    writes = {"fill_ms": events_ms(torch, lambda: out.fill_(0.0)),
              "index_fill_by_perm_ms": events_ms(
                  torch, lambda: out.index_fill_(0, perm, 0.0)),
              "bytes": out.numel() * 4}
    print(json.dumps({"write_yardsticks": writes}), flush=True)
    del out, perm
    order = groups.perm.long()
    inputs = {"edges_sorted_by_user": (
        xu, xi, user[order].contiguous(), item[order].contiguous(),
        mask[order].contiguous()),
        "items_folded_to_1024_rows": (xu, xi, user, item % 1024, mask)}
    diag = {}
    for name, (x, y, src, dst, m) in inputs.items():
        grp = group_edges(src, dst, m)
        for op in TIMED:
            diag[f"{name} {op} ms"] = events_ms(torch, lambda: ops.sddmm(
                op, x, y, src, dst, m, impl="cuda", groups=grp))
        del grp
    print(json.dumps({"rearranged_inputs": diag}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ab": {op: {"parent_ms": min(v["parent_ms"]),
                                  "change_ms": min(v["change_ms"])}
                             for op, v in rows.items()},
                      "groups_build_ms": build_ms, "card": smi}), flush=True)
    return 0


# ------------------------------------------------------------ embedding_bag
EB_USERS, EB_BATCH, EB_BAG = N_USERS, 256, 8
EB_CALLS = 10_000


def load_parent_gather(parent: pathlib.Path):
    """The parent's ``embedding_bag`` wrapper, its library and its
    ``eval/topk.py::_gather_rows``, each run as the parent's own source:
    the modules are loaded from the parent's files under other names and
    pointed at one another (the parent's ``_build`` builds the parent's
    ``embedding_bag.cu`` into the parent's ``build/``)."""
    import importlib.util

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(
            name, parent / "src" / "repro_torch" / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    bld = load("parent_build", "kernels/_build.py")
    eb = load("parent_embedding_bag", "kernels/embedding_bag.py")
    eb._build = bld
    ops = load("parent_ops", "kernels/ops.py")
    ops.embedding_bag_cuda = eb.embedding_bag_cuda
    topk = load("parent_topk", "eval/topk.py")
    topk.kops = ops
    bld.build_all(("embedding_bag",))
    return {"build": bld, "wrapper": eb.embedding_bag_cuda,
            "gather_rows": topk._gather_rows}


def parent_pieces(torch, bld, table, ids, mask) -> dict:
    """Host µs per piece of the parent's wrapper, as its source runs
    them, each over ``EB_CALLS`` calls."""
    from chip_smoke import host_us
    b, bag_len = ids.shape
    d = table.shape[1]

    def checks():
        combiner = "sum"
        if combiner not in ("sum", "mean"):
            raise ValueError(combiner)
        if not table.is_cuda:
            raise ValueError("table")
        if table.dtype != torch.float32 or table.dim() != 2 \
                or not table.is_contiguous():
            raise ValueError("table")
        if ids.dtype != torch.int32 or ids.dim() != 2 \
                or not ids.is_contiguous():
            raise ValueError("ids")
        if mask.dtype != torch.bool or mask.shape != ids.shape \
                or not mask.is_contiguous():
            raise ValueError("mask")
        if ids.device != table.device or mask.device != table.device:
            raise ValueError("device")

    out = torch.empty((b, d), dtype=torch.float32, device=table.device)

    def call():
        vec4 = d % 4 == 0 and table.data_ptr() % 16 == 0 \
            and out.data_ptr() % 16 == 0
        lib = bld.load("embedding_bag")
        err = lib.embedding_bag_f32(
            table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, bag_len, d, 0, int(vec4),
            table.device.index or 0,
            ctypes.c_void_p(torch.cuda.current_stream(
                table.device).cuda_stream))
        bld.check(lib, err, "embedding_bag")

    return {
        "checks": host_us(torch, checks, EB_CALLS),
        "torch_empty": host_us(torch, lambda: torch.empty(
            (b, d), dtype=torch.float32, device=table.device), EB_CALLS),
        "stream_query": host_us(torch, lambda: ctypes.c_void_p(
            torch.cuda.current_stream(table.device).cuda_stream), EB_CALLS),
        "ctypes_call_with_launch": host_us(torch, call, EB_CALLS),
    }


def main_embedding_bag(args) -> int:
    """``embedding_bag`` of the parent against the change, in one process:
    bit equality for sum and mean at L = 1 and L = 8 (masked and, for the
    change, unmasked with int32 and int64 ids), then per turn the host µs
    per wrapper call and per ``_gather_rows`` (``EB_CALLS`` calls on a host
    clock), the device µs (100 calls in a CUDA graph) and the µs between
    CUDA events, and the pieces of each wrapper's host path."""
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, host_us
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    turns = args.turns.upper()
    parent = load_parent_gather(args.parent.resolve())
    with_change = "C" in turns
    if with_change:
        from chip_smoke import itemise_embedding_bag
        from repro_torch.eval.topk import _gather_rows
        from repro_torch.kernels import _build
        from repro_torch.kernels.embedding_bag import embedding_bag_cuda
        from repro_torch.kernels.ref import embedding_bag_ref
        _build.build_all(("embedding_bag",))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn((EB_USERS, D), device=dev, generator=gen)

    same = {}
    if with_change:
        for bag_len in (1, EB_BAG):
            ids = torch.randint(0, EB_USERS, (EB_BATCH, bag_len), device=dev,
                                generator=gen, dtype=torch.int32)
            mask = torch.rand((EB_BATCH, bag_len), device=dev,
                              generator=gen) > 0.3
            mask[0] = False
            full = torch.ones_like(mask)
            for comb in ("sum", "mean"):
                want = parent["wrapper"](table, ids, mask, comb)
                want_full = parent["wrapper"](table, ids, full, comb)
                got = {
                    "masked_i32": embedding_bag_cuda(table, ids, mask, comb),
                    "masked_i64": embedding_bag_cuda(table, ids.long(), mask,
                                                     comb),
                    "no_mask_i32": embedding_bag_cuda(table, ids, None, comb),
                    "no_mask_i64": embedding_bag_cuda(table, ids.long(), None,
                                                      comb)}
                plain = {"masked": embedding_bag_ref(table, ids, mask, comb),
                         "no_mask": embedding_bag_ref(table, ids.long(), None,
                                                      comb)}
                row = {}
                for name, t in got.items():
                    ref = want if name.startswith("masked") else want_full
                    row[f"{name}_eq_parent"] = torch.equal(t, ref)
                    row[f"{name}_eq_plain"] = torch.equal(
                        t, plain[name.rsplit("_", 1)[0]])
                same[f"{comb} L={bag_len}"] = row
        print(json.dumps({"bitwise": same}), flush=True)
        if not all(all(r.values()) for r in same.values()):
            raise RuntimeError("embedding_bag: not bitwise equal")

    sel = torch.randint(0, EB_USERS, (EB_BATCH,), device=dev, generator=gen,
                        dtype=torch.int32)
    sel64 = sel.long()
    ids1 = sel[:, None].contiguous()
    mask1 = torch.ones_like(ids1, dtype=torch.bool)
    sides = {"P": {"wrapper": lambda: parent["wrapper"](table, ids1, mask1),
                   "gather_i32": lambda: parent["gather_rows"](table, sel,
                                                               "cuda"),
                   "gather_i64": lambda: parent["gather_rows"](table, sel64,
                                                               "cuda")}}
    if with_change:
        sides["C"] = {"wrapper": lambda: embedding_bag_cuda(table, ids1, None),
                      "wrapper_masked": lambda: embedding_bag_cuda(
                          table, ids1, mask1),
                      "gather_i32": lambda: _gather_rows(table, sel, "cuda"),
                      "gather_i64": lambda: _gather_rows(table, sel64,
                                                         "cuda")}
    rows = {"P": [], "C": []}
    for who in turns:
        rec = {}
        for name, fn in sides[who].items():
            rec[f"{name}_host_us"] = host_us(torch, fn, EB_CALLS)
        rec["wrapper_device_us"] = device_ms(torch, sides[who]["wrapper"]) \
            * 1e3
        rec["wrapper_call_us"] = events_ms(torch, sides[who]["wrapper"],
                                           reps=100) * 1e3
        rec["gather_i32_call_us"] = events_ms(
            torch, sides[who]["gather_i32"], reps=100) * 1e3
        rec["pieces_host_us"] = parent_pieces(
            torch, parent["build"], table, ids1, mask1) if who == "P" \
            else itemise_embedding_bag(torch, table, ids1, EB_CALLS)
        rows[who].append(rec)
        print(json.dumps({"turn": "parent" if who == "P" else "change",
                          "work": f"B={EB_BATCH} L=1 D={D}", **rec}),
              flush=True)
    print(smi, flush=True)
    summary = {who: {k: min(r[k] for r in recs) for k in recs[0]
                     if k != "pieces_host_us"}
               for who, recs in rows.items() if recs}
    print(json.dumps({"ab": "embedding_bag", "best_of_turns": summary,
                      "bitwise": bool(same) and all(
                          all(r.values()) for r in same.values()),
                      "card": smi}), flush=True)
    return 0


TOPK_USERS, TOPK_K, TOPK_SEEN = 256, 20, 64


def main_topk(args) -> int:
    """``fused_topk_score`` of the parent against the change, in one
    process (see the module's docstring)."""
    import math

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _topk_case
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.topk_score import (fused_topk_score_cuda,
                                                split_plan)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "topk_score_parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(args.parent.resolve()
                        / "src/repro_torch/kernels/csrc/topk_score.cu")],
                   check=True)
    _build.build_all(("topk_score",))
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_topk_score_f32
    fn.argtypes = _build.SIGNATURES["topk_score"]["fused_topk_score_f32"]
    fn.restype = _I
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def parent(ue, table, seen, smask, k, n_items):
        b, d = ue.shape
        out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
        splits, per = split_plan(b, n_items, k, sms)
        part_s, part_i = (out_s, out_i) if splits == 1 else (
            torch.empty((splits, b, k), dtype=torch.float32, device=dev),
            torch.empty((splits, b, k), dtype=torch.int32, device=dev))
        bits = torch.empty((b, math.ceil(n_items / 32)), dtype=torch.int32,
                           device=dev)
        vec4 = d % 4 == 0 and ue.data_ptr() % 16 == 0 \
            and table.data_ptr() % 16 == 0
        err = fn(ue.data_ptr(), table.data_ptr(), seen.data_ptr(),
                 smask.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                 part_s.data_ptr(), part_i.data_ptr(), bits.data_ptr(), b, d,
                 table.shape[0], n_items, seen.shape[1], k, per, splits,
                 int(vec4), *_build.stream_of(ue))
        if err:
            raise RuntimeError(f"parent fused_topk_score: error {err}")
        return out_s, out_i

    def change(ue, table, seen, smask, k, n_items):
        return fused_topk_score_cuda(ue, table, seen, smask, k=k,
                                     n_items=n_items)

    def plain(ue, table, seen, smask, k, n_items):
        return ref.fused_topk_score_ref(ue, table, seen, smask, k=k,
                                        n_items=n_items, item_block=1024)

    def same(a, b):
        return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) \
            and torch.equal(a[1], b[1])

    gen = torch.Generator(device=dev).manual_seed(0)
    ue = torch.randn((TOPK_USERS, D), generator=gen, device=dev)
    table = torch.randn((N_ITEMS, D), generator=gen, device=dev)
    seen = torch.randint(0, N_ITEMS, (TOPK_USERS, TOPK_SEEN), generator=gen,
                         device=dev, dtype=torch.int32)
    smask = torch.rand((TOPK_USERS, TOPK_SEEN), generator=gen,
                       device=dev) < 0.5
    main = (ue, table, seen, smask, TOPK_K, N_ITEMS)
    case = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in _topk_case(np.random.default_rng(0), "nan_inf")[:4]]
    nan_inf = (*case, 20, 1000)
    eq = {"main_change_eq_parent": same(change(*main), parent(*main)),
          "main_change_eq_plain": same(change(*main), plain(*main)),
          "nan_inf_change_eq_plain": same(change(*nan_inf), plain(*nan_inf)),
          "nan_inf_parent_eq_plain": same(parent(*nan_inf), plain(*nan_inf))}
    print(json.dumps({"bitwise": eq}), flush=True)
    if not (eq["main_change_eq_parent"] and eq["main_change_eq_plain"]
            and eq["nan_inf_change_eq_plain"]):
        raise RuntimeError("fused_topk_score: not bitwise equal")
    sides = {"P": lambda: parent(*main), "C": lambda: change(*main)}
    rows = {"P": [], "C": []}
    for who in args.turns.upper():
        ms = events_ms(torch, sides[who], reps=50)
        rows[who].append(ms)
        print(json.dumps({"turn": who, "ms": ms}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernel": "fused_topk_score", "card": smi,
                      "shape": {"users": TOPK_USERS, "items": N_ITEMS, "d": D,
                                "k": TOPK_K, "seen": TOPK_SEEN},
                      "parent_ms": rows["P"], "change_ms": rows["C"],
                      "bitwise": eq}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

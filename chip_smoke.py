#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repo root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. device: require CUDA; print the card's name and power limit;
  2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, in parallel) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card, at
     adversarial shapes and at the main paths' shapes, and time kernel,
     plain version and (where one exists) a single PyTorch library call;
  4. drive the serving path at the LightGCN FULL width
     (``src/repro/configs/lightgcn.py:7``: 349,184 users x 53,248 items,
     D = 128, 3 layers) with 2^24 requested edges: data -> BipartiteCSR
     -> seeded init -> forward -> Recommender -> RecommenderService
     serving 1,024 Zipf-drawn requests -> held-out evaluation, with every
     response checked and the serving kernels' launch counts read;
  5. drive the training path at the NGCF FULL width
     (``src/repro/configs/ngcf.py:21``: the same users, items and D,
     target batch 150,528) on the same graph, with depth cut from 3 to 2
     layers (see TRAIN_LAYERS): Pipeline.step_fn for 3 Adam steps of 2
     accumulated microbatches each, fused Hadamard route; the first
     microbatch's loss and gradients held against the plain route, and
     the training kernels' launch counts read;
  6. print ``{"kernels": [...]}`` and, last, the device line.
Imports torch, numpy and the port; never JAX or the ``repro`` package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# LightGCN FULL (src/repro/configs/lightgcn.py:7); NGCF FULL
# (src/repro/configs/ngcf.py:21) has the same users, items, D and layers
N_USERS, N_ITEMS, EMBED_DIM, N_LAYERS = 349_184, 53_248, 128, 3
FULL_EDGES = 250_085_376
EDGES = 1 << 24            # the one cut: host-side generation time
SEED = 0
K, ITEM_BLOCK, USER_BATCH = 20, 1024, 256
MAX_BATCH, MAX_WAIT_US, N_REQUESTS, ARRIVAL_US = 64, 1_000, 1_024, 50
N_EVAL_USERS = 16_384
N_SAMPLE = 256
RTOL = ATOL = 1e-5         # fp32 sums in another order than the plain version
# NGCF FULL training: target batch 150,528 in 2 microbatches, 3 steps
TARGET_BATCH, MICROBATCH, TRAIN_STEPS = 150_528, 75_264, 3
# Depth cut: the reference's NGCF sums messages without degree
# normalisation, and each layer's Hadamard term multiplies two aggregated
# embeddings, so activations grow about quadratically per layer over
# rows of up to 256k edges; with 3 layers the first backward overflows
# float32 on this graph (gradients inf/NaN), with 2 it stays finite.
TRAIN_LAYERS = 2
GRAD_RTOL = 1e-4           # per gradient leaf, relative in the norm
# H100 SXM datasheet peaks (NVIDIA, dense, without sparsity)
PEAK_FP32 = 67e12          # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12       # bytes/s, HBM3

TOLERANCE = {
    "spmm_csr": f"adversarial: allclose rtol={RTOL} atol={ATOL}; main: "
                f"|err| <= {ATOL} + {RTOL} * sum of |terms| per element",
    "embedding_bag": f"allclose rtol={RTOL} atol={ATOL}",
    "fused_topk_score": "ids and scores bitwise on integer-valued inputs; "
                        f"else scores allclose rtol={RTOL} atol={ATOL} and "
                        "ids equal except at near-ties",
    "hadamard_spmm": "bitwise on integer-valued inputs; adversarial: "
                     f"allclose rtol={RTOL} atol={ATOL}; main: |err| <= "
                     f"{ATOL} + {RTOL} * sum of |terms| per element",
}

KERNELS = {
    "spmm_csr": ("src/repro_torch/kernels/csrc/spmm_csr.cu",
                 "src/repro/kernels/spmm.py:84"),
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:55"),
    "fused_topk_score": ("src/repro_torch/kernels/csrc/topk_score.cu",
                         "src/repro/kernels/topk_score.py:90"),
    "hadamard_spmm": ("src/repro_torch/kernels/csrc/hadamard_spmm.cu",
                      "src/repro/kernels/hadamard_spmm.py:106"),
}
# the kernels each main path runs
SERVING_KERNELS = ("spmm_csr", "embedding_bag", "fused_topk_score")
TRAINING_KERNELS = ("spmm_csr", "hadamard_spmm")


class SmokeFailure(RuntimeError):
    pass


def require(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ phase 1
def setup():
    """Import torch and the port; fail without a card or without the repo."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no card")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure(f"{src / 'repro_torch'} not found: run from a "
                           "checkout of the repo")
    sys.path.insert(0, str(src))
    # fp32 means fp32: no TF32 in the plain versions' matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return torch


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "kernels": sorted(_build.SIGNATURES),
          "seconds": round(secs, 3)})
    return secs


# ---------------------------------------------------------------- helpers
def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    """Max |a - b| over finite entries; non-finite entries must match."""
    a = a.float().cpu().numpy()
    b = b.float().cpu().numpy()
    fin = np.isfinite(a) & np.isfinite(b)
    require(np.array_equal(a[~fin], b[~fin]), "non-finite entries differ")
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def close(torch, got, want, what: str) -> float:
    err = max_err(got, want)
    require(torch.allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=False)
            or err == 0.0, f"{what}: max |err| {err} over rtol/atol {RTOL}")
    return err


def topk_agree(s_k, i_k, s_p, i_p, what: str, exact: bool = False) -> int:
    """Scores agree position-wise to RTOL/ATOL; ids agree everywhere except
    at near-ties: where a neighbouring score (or the list's end, beyond
    which the next candidate is not shown) lies within the tolerance.
    With exact=True (integer-valued inputs) both must match bitwise.
    Returns the number of id mismatches excused as near-ties."""
    s_k, s_p = np.asarray(s_k), np.asarray(s_p)
    i_k, i_p = np.asarray(i_k), np.asarray(i_p)
    require(s_k.shape == s_p.shape == i_k.shape == i_p.shape,
            f"{what}: shapes differ")
    if exact:
        require(np.array_equal(s_k, s_p) and np.array_equal(i_k, i_p),
                f"{what}: not bitwise equal on integer-valued inputs")
        return 0
    fin = np.isfinite(s_p)
    require(np.array_equal(np.isfinite(s_k), fin)
            and np.array_equal(s_k[~fin], s_p[~fin])
            and np.array_equal(i_k[~fin], i_p[~fin]),
            f"{what}: invalid slots differ")
    require(np.allclose(s_k[fin], s_p[fin], rtol=RTOL, atol=ATOL),
            f"{what}: scores differ beyond rtol/atol {RTOL}")
    tol = ATOL + RTOL * np.abs(s_p)
    near = np.zeros_like(fin)
    near[:, -1] = True
    gap = np.abs(np.diff(s_p, axis=1)) <= tol[:, 1:]
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    bad = (i_k != i_p)
    require(not (bad & ~near).any(),
            f"{what}: ids differ away from any near-tie")
    return int(bad.sum())


# ------------------------------------------------------------------ phase 3
def check_spmm(torch, dev, rng) -> float:
    """Adversarial shapes: D not a multiple of 4 or 128, empty rows (max ->
    0), zero edges, ragged per-edge values."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmm import build_csr_by_dst
    worst = 0.0
    for n, e, d, gather in [(1000, 5000, 100, True), (1000, 5000, 128, True),
                            (333, 2000, 130, False), (7, 0, 128, True),
                            (9, 30, 37, False), (5, 1, 8, True)]:
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, max(n // 2, 1), e).astype(np.int32)
        indptr, src_sorted, perm = build_csr_by_dst(dst, src, n)
        vals = rng.standard_normal((n if gather else e, d)).astype(np.float32)
        if not gather:
            vals = vals[perm]
        v = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
        ip = torch.from_numpy(indptr).to(dev, torch.int64)
        s = torch.from_numpy(src_sorted).to(dev)
        empty = torch.from_numpy(np.diff(indptr) == 0).to(dev)
        require(bool(empty.any()), "spmm case has no empty row")
        for reduce in ("sum", "max"):
            got = ops.spmm_csr(reduce, v, ip, s, n, gather=gather, impl="cuda")
            want = ref.spmm_csr_ref(reduce, v, ip, s, n, gather=gather)
            torch.cuda.synchronize()
            worst = max(worst, close(torch, got, want,
                                     f"spmm_csr {reduce} n={n} e={e} d={d}"))
            require(bool((got[empty] == 0).all()), "spmm empty row != 0")
    return worst


def check_embedding_bag(torch, dev, rng) -> float:
    """L > 1 with a mask (one bag fully masked), sum and mean, D % 4 != 0."""
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for v, b, l, d in [(1000, 300, 5, 128), (17, 5, 3, 100), (33, 7, 2, 130),
                       (9, 1, 4, 37)]:
        table = torch.from_numpy(
            rng.standard_normal((v, d)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, v, (b, l)).astype(np.int32)).to(dev)
        mask_np = rng.random((b, l)) > 0.4
        mask_np[0, :] = False
        mask = torch.from_numpy(mask_np).to(dev)
        for combiner in ("sum", "mean"):
            got = ops.embedding_bag(table, ids, mask, combiner, impl="cuda")
            want = ref.embedding_bag_ref(table, ids, mask, combiner)
            torch.cuda.synchronize()
            worst = max(worst, close(torch, got, want,
                                     f"embedding_bag {combiner} L={l} d={d}"))
            require(bool((got[0] == 0).all()), "embedding_bag empty bag != 0")
    return worst


def _topk_case(rng, case):
    b, ni, d, k, L = 37, 1000, 128, 20, 40
    ue = rng.integers(-2, 3, (b, d)).astype(np.float32)
    ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
    seen = rng.integers(0, ni, (b, L)).astype(np.int32)
    mask = rng.random((b, L)) < 0.5
    if case == "integer_ties":
        ie = np.repeat(ie[: ni // 3 + 1], 3, axis=0)[:ni]
    elif case == "neg_zero":
        ue = np.full((b, d), -1.0, np.float32)
        ie[::2] = 0.0                         # (-1)·0 = -0.0 before canonical
    elif case == "k_gt_catalogue":
        ni, k = 6, 11
        ie = ie[:ni]
        seen = np.minimum(seen, ni - 1)
    elif case == "fully_masked":
        ni = L = 6
        ie = ie[:ni]
        seen = np.broadcast_to(np.arange(ni, dtype=np.int32), (b, ni)).copy()
        mask = np.ones((b, ni), bool)
    elif case == "ragged_d":
        d, b = 130, 7
        ue = rng.integers(-2, 3, (b, d)).astype(np.float32)
        ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
        seen, mask = seen[:b], mask[:b]
    elif case == "empty_seen":
        seen = np.zeros((b, 0), np.int32)
        mask = np.zeros((b, 0), bool)
    elif case == "k_max":
        k, ni = 256, 3000
        ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
    return ue, ie, seen, mask, k, ni


def check_topk(torch, dev, rng) -> float:
    """Integer-valued inputs (ids and scores bitwise): forced ties, -0.0,
    K > catalogue, fully masked users, an empty seen list, D % 4 != 0,
    K at its maximum; plus real-valued scores (near-tie rule)."""
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for case in ("integer_ties", "neg_zero", "k_gt_catalogue", "fully_masked",
                 "ragged_d", "empty_seen", "k_max", "float"):
        ue, ie, seen, mask, k, ni = _topk_case(rng, case)
        if case == "float":
            ue = rng.standard_normal(ue.shape).astype(np.float32)
            ie = rng.standard_normal(ie.shape).astype(np.float32)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (ue, ie, seen, mask)]
        for blk in (64, 1000):
            s_k, i_k = ops.fused_topk_score(*args, k=k, n_items=ni,
                                            item_block=blk, impl="cuda")
            s_p, i_p = ref.fused_topk_score_ref(*args, k=k, n_items=ni,
                                                item_block=blk)
            torch.cuda.synchronize()
            topk_agree(s_k.cpu(), i_k.cpu(), s_p.cpu(), i_p.cpu(),
                       f"fused_topk_score {case} blk={blk}",
                       exact=case != "float")
            worst = max(worst, max_err(s_k, s_p))
        if case == "fully_masked":
            require(bool((i_k == -1).all()), "fully masked user got an id")
        if case == "k_gt_catalogue":
            require(bool((i_k[:, ni:] == -1).all()), "short slot id != -1")
    return worst


def check_hadamard(torch, dev, rng) -> float:
    """General form (x_idx != y_idx): D in {128, 100, 130, 37}, empty rows,
    zero edges, the scale + leaky-relu epilogue, and integer-valued inputs
    (with and without the epilogue) that must match bitwise."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmm import build_csr_by_dst
    worst = 0.0
    for n_src, n, e, d, integer, epi in [
            (1000, 800, 6000, 128, False, False),
            (1000, 800, 6000, 100, False, True),
            (333, 200, 2000, 130, False, True), (50, 40, 300, 37, False, False),
            (7, 9, 0, 128, False, True), (120, 90, 900, 128, True, False),
            (120, 90, 900, 37, True, True), (60, 50, 400, 130, True, True)]:
        dst = rng.integers(0, max(n // 2, 1), e)
        indptr, x_idx, perm = build_csr_by_dst(dst, rng.integers(0, n_src, e), n)
        y_idx = rng.integers(0, n, e).astype(np.int32)[perm]
        require(e == 0 or not np.array_equal(x_idx, y_idx), "x_idx == y_idx")
        if integer:
            x = rng.integers(-3, 4, (n_src, d)).astype(np.float32)
            y = rng.integers(-3, 4, (n, d)).astype(np.float32)
            scale = rng.integers(-2, 3, n).astype(np.float32)
        else:
            x = rng.standard_normal((n_src, d)).astype(np.float32)
            y = rng.standard_normal((n, d)).astype(np.float32)
            scale = rng.standard_normal(n).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (x, y)]
        args += [torch.from_numpy(indptr).to(dev, torch.int64),
                 torch.from_numpy(x_idx).to(dev), torch.from_numpy(y_idx).to(dev),
                 n]
        kw = dict(scale=torch.from_numpy(scale).to(dev), slope=0.2) if epi else {}
        got = ops.hadamard_spmm(*args, impl="cuda", **kw)
        want = ref.hadamard_spmm_ref(*args, **kw)
        torch.cuda.synchronize()
        what = f"hadamard_spmm n={n} e={e} d={d} epilogue={epi}"
        if integer:
            require(torch.equal(got, want), f"{what}: not bitwise on integers")
        else:
            worst = max(worst, close(torch, got, want, what))
        empty = torch.from_numpy(np.diff(indptr) == 0).to(dev)
        require(bool(empty.any()), "hadamard case has no empty row")
        require(bool((got[empty] == 0).all()), "hadamard empty row != 0")
    return worst


# ------------------------------------------------------------------ phase 4
def build_graph(torch, dev):
    from repro_torch.data import synth
    from repro_torch.pipeline import BipartiteCSR
    t0 = time.perf_counter()
    data = synth.generate_bipartite(N_USERS, N_ITEMS, EDGES, seed=SEED)
    train, test = synth.train_test_split(data, 0.1, seed=SEED)
    t1 = time.perf_counter()
    g = BipartiteCSR(train.user, train.item, N_USERS, N_ITEMS, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    deg_i = np.diff(g.ui_indptr.cpu().numpy())
    deg_u = np.diff(g.iu_indptr.cpu().numpy())
    emit({"reduced": {"n_edges": EDGES, "config_n_edges": FULL_EDGES,
                      "after_dedup": data.n_edges, "train_edges": train.n_edges,
                      "why": "host-side graph generation time; widths, "
                             "users, items and layers are the config's"}})
    emit({"phase": "graph", "generate_s": round(t1 - t0, 3),
          "csr_s": round(t2 - t1, 3), "max_item_degree": int(deg_i.max()),
          "max_user_degree": int(deg_u.max()),
          "mean_item_degree": float(deg_i.mean()),
          "mean_user_degree": float(deg_u.mean())})
    return g, train, test


def close_sum(torch, got, want, abs_sum, what: str) -> float:
    """fp32 sums in two orders: |got - want| <= ATOL + RTOL * sum of |terms|
    per element (a row of 256k edges cancels to values far below its
    terms, where a tolerance relative to the result itself means nothing)."""
    err = max_err(got, want)
    ok = ((got - want).abs() <= ATOL + RTOL * abs_sum).all()
    require(bool(ok), f"{what}: max |err| {err} over {RTOL} x sum|terms|")
    return err


def time_kernels(torch, g, params, user_f, item_f, eval_users, errs):
    """Each kernel at the main path's shapes and inputs: kernel, plain
    version and library call on the same inputs; bound from this run's
    inputs."""
    from repro_torch.eval.topk import _gather_rows, _padded_seen
    from repro_torch.kernels import ops, ref
    dev = user_f.device
    out = {}

    # spmm_csr: layer 1's two gather-SpMMs (u2i then i2u), on the
    # degree-scaled embeddings sym_propagate hands them
    xu = (params["user_embed"] * g.rsqrt_du[:, None]).contiguous()
    xi = (params["item_embed"] * g.rsqrt_di[:, None]).contiguous()
    dirs = [(xu, g.ui_indptr, g.ui_src, N_ITEMS),
            (xi, g.iu_indptr, g.iu_src, N_USERS)]
    ms = plain = lib = bytes_ = flops = 0.0
    per_dir = []
    for x, ip, src, n in dirs:
        got = ops.spmm_csr("sum", x, ip, src, n, gather=True, impl="cuda")
        want = ref.spmm_csr_ref("sum", x, ip, src, n, gather=True)
        abs_sum = ref.spmm_csr_ref("sum", x.abs(), ip, src, n, gather=True)
        errs["spmm_csr"] = max(errs["spmm_csr"], close_sum(
            torch, got, want, abs_sum, "spmm_csr main"))
        del want, abs_sum
        with warnings.catch_warnings():     # beta-state notices only
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(ip, src.long(),
                                        torch.ones(src.numel(), device=dev),
                                        size=(n, x.shape[0]))
        t_k = cuda_ms(torch, lambda: ops.spmm_csr(
            "sum", x, ip, src, n, gather=True, impl="cuda"), reps=5)
        t_p = cuda_ms(torch, lambda: ref.spmm_csr_ref(
            "sum", x, ip, src, n, gather=True), reps=3, warmup=1)
        t_l = cuda_ms(torch, lambda: torch.sparse.mm(a, x), reps=5)
        del a
        rows_read = int(torch.unique(src).numel())
        bytes_ += (rows_read * x.shape[1] * 4 + ip.numel() * 8
                   + src.numel() * 4 + n * x.shape[1] * 4)
        flops += src.numel() * x.shape[1]
        ms, plain, lib = ms + t_k, plain + t_p, lib + t_l
        per_dir.append({"n_dst": n, "edges": int(src.numel()),
                        "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                        "gathered_row_bytes": src.numel() * x.shape[1] * 4})
    b_ms, b_by = bound(bytes_, flops)
    out["spmm_csr"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by, per_direction=per_dir,
                           work=f"one layer: agg_u2i + agg_i2u, D={EMBED_DIM}")

    # embedding_bag: the user-row gather of one 256-user batch (L = 1)
    users = torch.from_numpy(eval_users[:USER_BATCH]).to(dev)
    ids = users.to(torch.int32)[:, None].contiguous()
    mask = torch.ones_like(ids, dtype=torch.bool)
    got = _gather_rows(user_f, users, "cuda")
    want = ref.embedding_bag_ref(user_f, ids, mask, "sum")
    errs["embedding_bag"] = max(errs["embedding_bag"],
                                close(torch, got, want, "embedding_bag main"))
    t_k = cuda_ms(torch, lambda: ops.embedding_bag(user_f, ids, mask, "sum",
                                                   impl="cuda"), reps=50)
    t_p = cuda_ms(torch, lambda: ref.embedding_bag_ref(user_f, ids, mask,
                                                       "sum"), reps=50)
    ids64 = ids.long()
    t_l = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
        ids64, user_f, mode="sum"), reps=50)
    b_ms, b_by = bound(ids.numel() * EMBED_DIM * 4 + ids.numel() * 5
                       + ids.numel() * EMBED_DIM * 4, ids.numel() * EMBED_DIM)
    out["embedding_bag"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=b_ms, bound_by=b_by,
                                work=f"B={ids.shape[0]} L=1 D={EMBED_DIM}")

    # fused_topk_score: one 256-user batch against the whole catalogue
    ue = _gather_rows(user_f, users, "cuda")
    deg = g.iu_indptr[users.long() + 1] - g.iu_indptr[users.long()]
    seen_ip = g.iu_indptr
    seen_it = g.iu_src.long()
    seen, smask = _padded_seen(users, seen_ip, seen_it, int(deg.max()))
    kw = dict(k=K, n_items=N_ITEMS, item_block=ITEM_BLOCK)
    s_k, i_k = ops.fused_topk_score(ue, item_f, seen, smask, impl="cuda", **kw)
    s_p, i_p = ref.fused_topk_score_ref(ue, item_f, seen, smask, **kw)
    excused = topk_agree(s_k.cpu(), i_k.cpu(), s_p.cpu(), i_p.cpu(),
                         "fused_topk_score main")
    errs["fused_topk_score"] = max(errs["fused_topk_score"],
                                   max_err(s_k, s_p))
    t_k = cuda_ms(torch, lambda: ops.fused_topk_score(
        ue, item_f, seen, smask, impl="cuda", **kw), reps=10)
    t_p = cuda_ms(torch, lambda: ref.fused_topk_score_ref(
        ue, item_f, seen, smask, **kw), reps=3, warmup=1)
    b_ms, b_by = bound(ue.numel() * 4 + item_f.numel() * 4 + seen.numel() * 5
                       + 2 * ue.shape[0] * K * 4,
                       2.0 * ue.shape[0] * N_ITEMS * EMBED_DIM)
    out["fused_topk_score"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        work=f"B={ue.shape[0]} I={N_ITEMS} D={EMBED_DIM} k={K} "
             f"seen_len={seen.shape[1]}", near_tie_id_swaps=excused)
    for name, rec in out.items():
        detail = {k: v for k, v in rec.items() if k != "ms"}
        emit({"kernel": name, "kernel_ms": rec["ms"], **detail,
              "max_abs_err": errs[name], "tolerance": TOLERANCE[name]})
    return out


def forward(torch, g, params, model, layer_ms):
    """``model.forward`` with each layer's ``sym_propagate`` timed (host
    clock around a synchronised call)."""
    propagate = g.sym_propagate

    def timed(xu, xi):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = propagate(xu, xi)
        torch.cuda.synchronize()
        layer_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    g.sym_propagate = timed
    try:
        return model.forward(params, g, N_LAYERS)
    finally:
        del g.sym_propagate


def check_responses(torch, responses, users, rec, seen_ip, seen_it):
    from repro_torch.eval.topk import streaming_topk
    require(len(responses) == len(users), "lost requests")
    require([r.user_id for r in responses] == [int(u) for u in users],
            "responses out of order")
    for r in responses:
        ids, scores = np.asarray(r.ids), np.asarray(r.scores)
        require(ids.shape == (K,) and ((ids >= 0) & (ids < N_ITEMS)).all(),
                f"user {r.user_id}: not {K} valid ids")
        require(len(np.unique(ids)) == K, f"user {r.user_id}: repeated ids")
        require(np.isfinite(scores).all() and (np.diff(scores) <= 0).all(),
                f"user {r.user_id}: scores not finite and non-increasing")
        seen = seen_it[seen_ip[r.user_id]:seen_ip[r.user_id + 1]]
        require(not np.isin(ids, seen).any(),
                f"user {r.user_id}: recommended a seen item")
    # a sample against the plain route on the card
    sample, first = [], {}
    for r in responses:
        if r.user_id not in first:
            first[r.user_id] = r
            sample.append(r.user_id)
        if len(sample) == N_SAMPLE:
            break
    s_p, i_p = streaming_topk(rec.user_e, rec.item_e, K,
                              user_ids=np.asarray(sample, np.int32),
                              seen_indptr=rec.seen_indptr,
                              seen_items=rec.seen_items,
                              user_batch=USER_BATCH, item_block=ITEM_BLOCK,
                              impl="torch")
    s_k = np.stack([first[u].scores for u in sample])
    i_k = np.stack([first[u].ids for u in sample])
    return len(sample), topk_agree(s_k, i_k, s_p, i_p, "service vs plain")


def main_path(torch, g, test, params):
    from repro_torch import kernels
    from repro_torch.data import synth
    from repro_torch.eval import Recommender, evaluate_embeddings
    from repro_torch.pipeline import get_model
    from repro_torch.serving import ManualClock, RecommenderService

    model = get_model("lightgcn")
    seen_ip, seen_it = g.seen_csr()
    rng = np.random.default_rng(SEED)
    users = (rng.zipf(1.2, N_REQUESTS) - 1) % N_USERS
    test_pos = synth.group_by_user(test.user, test.item, N_USERS)
    has_test = np.array([len(p) > 0 for p in test_pos])
    eval_users = np.nonzero(has_test)[0][:N_EVAL_USERS]
    keep = np.zeros(N_USERS, bool)
    keep[eval_users] = True
    empty = np.zeros(0, np.int64)
    eval_pos = [p if keep[u] else empty for u, p in enumerate(test_pos)]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    layer_ms = []
    user_f, item_f = forward(torch, g, params, model, layer_ms)
    rec = Recommender(user_f, item_f, seen_indptr=seen_ip, seen_items=seen_it,
                      k=K, item_block=ITEM_BLOCK, user_batch=USER_BATCH,
                      device=g.device)
    clock = ManualClock()
    svc = RecommenderService(rec, max_batch=MAX_BATCH,
                             max_wait_us=MAX_WAIT_US, clock=clock)
    responses = []
    t_serve = time.perf_counter()
    for uid in users:
        clock.advance(ARRIVAL_US)
        svc.submit(int(uid))
        responses.extend(svc.poll())
    responses.extend(svc.drain())
    serve_s = time.perf_counter() - t_serve
    t_eval = time.perf_counter()
    metrics = evaluate_embeddings(user_f, item_f, eval_pos, k=K,
                                  seen_indptr=rec.seen_indptr,
                                  seen_items=rec.seen_items,
                                  user_batch=USER_BATCH, item_block=ITEM_BLOCK)
    eval_s = time.perf_counter() - t_eval
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernels.launch_counts()

    for name in SERVING_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the serving path")
    for name, t in (("user", user_f), ("item", item_f)):
        require(bool(torch.isfinite(t).all()), f"non-finite {name} embeddings")
    require(tuple(user_f.shape) == (N_USERS, EMBED_DIM)
            and tuple(item_f.shape) == (N_ITEMS, EMBED_DIM),
            "final embeddings have the wrong shape")
    n_sample, excused = check_responses(torch, responses, users, rec,
                                        seen_ip, seen_it)
    # the forward against the plain spmm on the card
    g.impl = "torch"
    ref_u, ref_i = forward(torch, g, params, model, [])
    g.impl = None
    fwd_err = max(close(torch, user_f, ref_u, "forward users"),
                  close(torch, item_f, ref_i, "forward items"))
    del ref_u, ref_i
    require(all(0.0 <= v <= 1.0 for v in metrics.values()),
            f"metrics out of [0, 1]: {metrics}")
    stats = svc.stats()
    require(stats["completed"] == N_REQUESTS and stats["rejected"] == 0,
            "service dropped requests")
    emit({"phase": "main_path", "layers": N_LAYERS,
          "forward_layer_ms": layer_ms, "forward_max_abs_err_vs_plain": fwd_err,
          "requests": N_REQUESTS, "batches": stats["batches"],
          "mean_occupancy": stats["mean_occupancy"],
          "service_p50_us": stats["service_p50_us"],
          "service_p99_us": stats["service_p99_us"],
          "total_p50_us": stats["total_p50_us"],
          "total_p99_us": stats["total_p99_us"],
          "serve_wall_s": serve_s, "eval_users": int(len(eval_users)),
          "eval_wall_s": eval_s, "metrics": metrics,
          "checked_responses": len(responses), "sample_vs_plain": n_sample,
          "sample_near_tie_id_swaps": excused, "main_path_s": total_s,
          "launches": launches})
    return user_f, item_f, launches, eval_users


# ------------------------------------------------------------------ phase 5
def value_and_grad_timed(torch, pipe, params, batch):
    """One microbatch's (loss, grads) as ``Pipeline.value_and_grad`` takes
    them, with forward and backward timed apart (host clock around
    synchronised work)."""
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = pipe.loss(live, *batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, tree_leaves(live))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, float(loss.detach()), grads


def train_path(torch, dev, train):
    """NGCF FULL training through ``Pipeline.step_fn``; returns the
    launches of the 3-step run, the pipeline and the layer-0 inputs (the
    initial user and item tables)."""
    from repro_torch import kernels
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    cfg = PipelineConfig(arch="ngcf", embed_dim=EMBED_DIM, n_layers=TRAIN_LAYERS,
                         optimizer="adam", target_batch=TARGET_BATCH,
                         base_batch=TARGET_BATCH, microbatch=MICROBATCH,
                         warmup_epochs=0, hadamard="auto", seed=SEED)
    emit({"reduced": {"n_layers": TRAIN_LAYERS, "config_n_layers": N_LAYERS,
                      "why": "3 unnormalised NGCF layers overflow float32 "
                             "in the backward on this graph's degrees"}})
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, train, device=dev)
    state = pipe.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    require(pipe.g.fused_hadamard, "hadamard='auto' did not pick the fused route")
    k = pipe.plan.microbatches_for_epoch(0)
    require(k == 2, f"{k} microbatches per step, expected 2")
    require(pipe.lr_for_epoch(0) == cfg.base_lr, "LR is not base_lr")

    # the first microbatch on the kernels (twice: the first call warms up)
    # and on the plain route
    users, pos, neg = pipe._next_target_batch(k, 0)
    batch = [pipe._batch(a[:MICROBATCH]) for a in (users, pos, neg)]
    fwd_ms, bwd_ms = [], []
    for _ in range(2):
        f, b, loss_k, grads_k = value_and_grad_timed(torch, pipe,
                                                     state["params"], batch)
        fwd_ms.append(f)
        bwd_ms.append(b)
    pipe.g.impl = "torch"
    before = kernels.launch_counts()
    pf, pb, loss_p, grads_p = value_and_grad_timed(torch, pipe,
                                                   state["params"], batch)
    require(kernels.launch_counts() == before, "the plain route launched a kernel")
    pipe.g.impl = None
    names = [f"leaf{i}{tuple(t.shape)}" for i, t in enumerate(grads_p)]
    grad_max = {n: float(t.abs().max()) for n, t in zip(names, grads_k)}
    for n, t in zip(names, grads_k):
        require(bool(torch.isfinite(t).all()), f"gradient {n} is not finite")
    rel = {n: float((a - b).norm() / b.norm())
           for n, a, b in zip(names, grads_k, grads_p)}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    require(loss_rel <= RTOL, f"first microbatch loss {loss_k} vs plain "
                              f"{loss_p}: relative {loss_rel}")
    for n, r in rel.items():
        require(r <= GRAD_RTOL, f"gradient {n}: relative error {r} in the norm")
    del grads_k, grads_p, batch

    # the main path: 3 steps from the seeded init, counts read around them
    pipe.seek(0)
    before = [t.detach().clone() for t in tree_leaves(state["params"])]
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = pipe.step_fn(state, step)
        torch.cuda.synchronize()
        steps.append({"step": step, "loss": loss,
                      "ms": (time.perf_counter() - t0) * 1e3})
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in TRAINING_KERNELS:
        require(launches[name] > 0, f"kernel {name} never launched on the "
                                    "training path")
    per_micro = TRAIN_STEPS * k * TRAIN_LAYERS
    require(launches["hadamard_spmm"] == per_micro * 6
            and launches["spmm_csr"] == per_micro * 4,
            f"unexpected training launches {launches}")
    require(all(np.isfinite(s["loss"]) for s in steps), "non-finite loss")
    after = tree_leaves(state["params"])
    require(all(bool(torch.isfinite(t).all()) for t in after),
            "non-finite params after training")
    changed = [not torch.equal(a, b) for a, b in zip(after, before)]
    require(all(changed), "a parameter did not change")
    emit({"phase": "train", "arch": "ngcf", "config": "ngcf-3l-128e",
          "layers": TRAIN_LAYERS,
          "target_batch": TARGET_BATCH, "microbatch": MICROBATCH,
          "microbatches_per_step": k, "optimizer": "adam",
          "lr": pipe.lr_for_epoch(0), "setup_s": setup_s, "steps": steps,
          "forward_ms_per_microbatch": fwd_ms,
          "backward_ms_per_microbatch": bwd_ms,
          "plain_forward_ms": pf, "plain_backward_ms": pb,
          "peak_memory_bytes": peak,
          "first_microbatch_loss": loss_k, "plain_loss": loss_p,
          "loss_rel_err": loss_rel, "grad_rel_err_norm": rel,
          "grad_max_abs": grad_max,
          "grad_tolerance": f"relative error in the norm <= {GRAD_RTOL} "
                            "per leaf; loss rtol " + str(RTOL),
          "launches": launches})
    return launches, pipe, (before[0], before[1])


def hadamard_bound(torch, x, y, indptr, x_idx, y_idx, n) -> tuple[float, float]:
    """(bytes, flops) the call must move and do: each distinct gathered row
    read once, indices, row pointers and the output once; 2 flops per
    gathered pair."""
    d = x.shape[1]
    rows = int(torch.unique(x_idx).numel()) * d * 4
    rows += int(torch.unique(y_idx).numel()) * d * 4
    idx = x_idx.numel() * 4 * (1 if y_idx is x_idx else 2)
    return rows + idx + indptr.numel() * 8 + n * d * 4, 2.0 * x_idx.numel() * d


def time_hadamard(torch, pipe, params, errs):
    """``hadamard_spmm`` at the training path's shapes, on layer-0 inputs:
    the forward pair of one NGCF layer and the two backward calls of
    ``hadamard_agg_item``; kernel, plain general version, the plain
    structured route, and a two-call library yardstick."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hadamard_spmm import hadamard_spmm_plain
    g = pipe.g
    dev = g.device
    xu, xi = params
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ct = torch.randn((N_ITEMS, EMBED_DIM), generator=gen, device=dev)
    calls = {
        "forward": [
            ("hadamard_agg_item", (xu, xi, g.ui_indptr, g.ui_src, g.ui_dst,
                                   N_ITEMS), "y_is_dst"),
            ("hadamard_agg_user", (xi, xu, g.iu_indptr, g.iu_src, g.iu_dst,
                                   N_USERS), "y_is_dst")],
        "backward": [
            ("d_x of hadamard_agg_item", (ct, xi, g.iu_indptr, g.iu_src,
                                          g.iu_src, N_USERS), "x_eq_y"),
            ("d_y of hadamard_agg_item", (xu, ct, g.ui_indptr, g.ui_src,
                                          g.ui_dst, N_ITEMS), "y_is_dst")],
    }
    out = {}
    for part, group in calls.items():
        tot = dict(ms=0.0, plain_ms=0.0, structured_ms=0.0, yardstick_ms=0.0,
                   bytes=0.0, flops=0.0)
        per_call = []
        for name, args, structure in group:
            x, y, ip, xi_, yi_, n = args
            got = ops.hadamard_spmm(*args, impl="cuda")
            want = ref.hadamard_spmm_ref(*args)
            abs_sum = ref.hadamard_spmm_ref(x.abs(), y.abs(), ip, xi_, yi_, n)
            errs["hadamard_spmm"] = max(errs["hadamard_spmm"], close_sum(
                torch, got, want, abs_sum, f"hadamard_spmm {name}"))
            del got, want, abs_sum
            t_k = cuda_ms(torch, lambda: ops.hadamard_spmm(*args, impl="cuda"),
                          reps=3, warmup=1)
            t_p = cuda_ms(torch, lambda: ref.hadamard_spmm_ref(*args),
                          reps=2, warmup=1)
            t_s = cuda_ms(torch, lambda: hadamard_spmm_plain(
                *args, structure=structure), reps=3, warmup=1)
            with warnings.catch_warnings():     # beta-state notices only
                warnings.simplefilter("ignore", UserWarning)
                a = torch.sparse_csr_tensor(ip, xi_.long(),
                                            torch.ones(xi_.numel(), device=dev),
                                            size=(n, x.shape[0]))
            if structure == "y_is_dst":
                yard = "torch.sparse.mm(A, x) * y"
                t_y = cuda_ms(torch, lambda: torch.sparse.mm(a, x) * y, reps=3)
            else:
                yard = "torch.sparse.mm(A, x * y)"
                t_y = cuda_ms(torch, lambda: torch.sparse.mm(a, x * y), reps=3)
            del a
            b, f = hadamard_bound(torch, *args)
            b_ms, b_by = bound(b, f)
            per_call.append({"call": name, "n_dst": n, "edges": int(xi_.numel()),
                             "ms": t_k, "plain_ms": t_p,
                             "structured_plain_ms": t_s, "structure": structure,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "two_call_yardstick": yard, "yardstick_ms": t_y})
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("structured_ms", t_s),
                           ("yardstick_ms", t_y), ("bytes", b), ("flops", f)):
                tot[key] += v
        b_ms, b_by = bound(tot["bytes"], tot["flops"])
        out[part] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"],
                         structured_plain_ms=tot["structured_ms"],
                         yardstick_ms=tot["yardstick_ms"], bound_ms=b_ms,
                         bound_by=b_by, per_call=per_call)
    return out


def main() -> int:
    torch = setup()
    build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    # no_grad, not inference_mode: the training phase reuses the graph's
    # data and autograd cannot save inference tensors
    with torch.no_grad():
        errs = {"spmm_csr": check_spmm(torch, dev, rng),
                "embedding_bag": check_embedding_bag(torch, dev, rng),
                "fused_topk_score": check_topk(torch, dev, rng),
                "hadamard_spmm": check_hadamard(torch, dev, rng)}
        emit({"phase": "adversarial", "max_abs_err": errs})
        g, train, test = build_graph(torch, dev)
        from repro_torch.pipeline import get_model
        params = get_model("lightgcn").init(SEED, N_USERS, N_ITEMS, EMBED_DIM,
                                            N_LAYERS, device=dev)
        user_f, item_f, serve_launches, eval_users = main_path(torch, g, test,
                                                               params)
        times = time_kernels(torch, g, params, user_f, item_f, eval_users,
                             errs)
    del g, params, user_f, item_f
    torch.cuda.empty_cache()
    train_launches, pipe, layer0 = train_path(torch, dev, train)
    with torch.no_grad():
        had = time_hadamard(torch, pipe, layer0, errs)
    per_step = train_launches["hadamard_spmm"] / TRAIN_STEPS
    for part, rec in had.items():
        emit({"kernel": "hadamard_spmm", "part": part, "kernel_ms": rec["ms"],
              **{k: v for k, v in rec.items() if k != "ms"},
              "launches_per_training_step": per_step,
              "work": f"layer 0, D={EMBED_DIM}, {train.n_edges} edges",
              "max_abs_err": errs["hadamard_spmm"],
              "tolerance": TOLERANCE["hadamard_spmm"]})
    times["hadamard_spmm"] = dict(had["forward"], library_ms=None)
    paths = {"serving": {k: serve_launches[k] for k in SERVING_KERNELS},
             "training": {k: train_launches[k] for k in TRAINING_KERNELS}}
    emit({"launches_by_path": paths})
    rows = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(p.get(name, 0) for p in paths.values()),
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)

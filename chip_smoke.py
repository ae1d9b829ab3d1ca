#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repo root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. device: require CUDA; print the card's name and power limit;
  2. build the six CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, in parallel) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card, at
     adversarial shapes (for ``spmm_csr`` and ``hadamard_spmm`` also their
     row split's cases, each called twice and required bitwise equal; for
     ``fused_topk_score`` k = 300 and 2,000 and ties across its split
     boundaries) and at the main paths' shapes, and time kernel, plain
     version and (where one exists) a single PyTorch library call, or a
     yardstick of a few calls where none exists; ``ann_block_scores``,
     ``embedding_bag`` and their library calls also on the device alone (a
     CUDA graph replay) and on the host;
  4. drive the serving path at the LightGCN FULL width
     (``src/repro/configs/lightgcn.py:7``: 349,184 users x 53,248 items,
     D = 128, 3 layers) with 2^24 requested edges: data -> BipartiteCSR
     -> seeded init -> forward -> Recommender -> RecommenderService
     serving 1,024 Zipf-drawn requests -> held-out evaluation, with every
     response checked and the serving kernels' launch counts read;
  5. drive ANN serving over tiered tables on the same final embeddings
     and the same 1,024 requests (``ann_serving``): device tables with
     keep_frac 1.0 (bitwise equal to the exact responses) and 0.125;
     both tables demoted to pinned host memory on ``h100-hbm-host``
     behind a 4,096-row hot-row cache (bitwise equal to the device
     tables on the same batches); the same with the int8 store (held
     against the plain route on a sample); plus the pinned host-to-device
     bandwidth; then k = 300 (past the top-K kernel's old cap) through
     the streaming top-K's fused route, ``ann_topk`` and
     ``evaluate_embeddings`` (``large_k``);
  6. drive the training path at the NGCF FULL width
     (``src/repro/configs/ngcf.py:21``: the same users, items and D,
     target batch 150,528) on the same graph, with depth cut from 3 to 2
     layers (see TRAIN_LAYERS): Pipeline.step_fn for 3 Adam steps of 2
     accumulated microbatches each, fused Hadamard route; the first
     microbatch's loss and gradients held against the plain route, and
     the training kernels' launch counts read;
  7. drive LightGCN FULL through the Experiment API (``api``):
     ``Experiment.from_preset("lightgcn-full")`` -> ``Run.fit`` for 3
     steps, ``Run.evaluate`` over every held-out user at the derived eval
     batch, ``Run.recommend`` against the plain route, a checkpointed run
     resumed bit for bit, and the CPU-sized presets on the card;
  8. the training half of the planner and tiers (``tiered_train``): both
     ``*-full`` presets built as they are (the derived microbatch 150,528
     and eval batch 4,096 required), then LightGCN FULL through
     ``Run.fit`` for 5 steps on ``h100-hbm-host`` in the arms
     (TIERED_ARMS): all on the device (A); both tables and their Adam
     moments demoted to pinned host memory (B, required bitwise equal to
     A, and lower in device memory between steps by at least 90 % of the
     demoted bytes); the same with the int8 store (C) and with int8 or
     top-k gradient compression (D), each held to the reference's
     tolerance on the smoke presets' schedule (lr 1e-3, against an A of
     that schedule) and reported at the preset's own lr; per arm the step,
     fetch and commit ms, link bytes, memory between steps, peak memory
     and the plan's est_penalty; then ``Run.evaluate`` on arm B, with
     ``_padded_seen``'s and ``ranking_metrics``' shares timed;
  9. sharded execution at one shard (``sharded``): a one-rank NCCL
     group through a ``FileStore``; ``lightgcn-full`` with ``mesh.spmm =
     "ring"`` through ``Run.fit`` (each layer one ``spmm_csr`` over the
     unified 402,432 rows), held against the kernel route of the same
     preset (first forward's embeddings, losses at the reference's
     sharded tolerance) and the int8 ring bit for bit the fp32 ring;
     ``Run.evaluate`` on the ring run; the bucket build, the ring's bytes,
     ring and kernel-route layer ms, step ms and the one-rank all-reduce;
  10. hold ``sddmm`` against its plain version at adversarial shapes
     (with and without edge groups: groups longer than several chunks,
     groups keyed on dst, groups of another call refused) and past 2^31
     output elements, then drive the seed COO path (``coo``) on the same
     graph, its user groups built once as set-up: the NGCF forward at
     each dataflow level O0-O3 and the LightGCN forward, each against the
     CSR route; the Fig 5 training arm
     (BPR gradients at O1-O3, 2 layers, against the CSR Pipeline; O0 vs O3
     on a 2^22-edge prefix); 3 steps each of the NGCF/LightGCN FULL cells'
     training step (``src/repro/launch/cells.py:739-776``); the Fig 6
     breakdown of one O3 layer; the ``sddmm`` kernel line ('mul' and
     'dot' walking the user groups, the edge-order walk beside them, and
     ``torch.sparse.sampled_addmm`` as the 'dot' yardstick);
  11. the subgraph-training baseline beside the full-graph step at depth
     1-3 (``subgraph``, the paper's headline comparison);
  12. print ``{"kernels": [...]}`` and, last, the device line.
Imports torch, numpy and the port; never JAX or the ``repro`` package.
"""
from __future__ import annotations

import gc
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
# past fused_topk_score's old cap of 256: the k of the large_k phase, over
# the first LARGE_K_USERS held-out users
LARGE_K, LARGE_K_USERS = 300, 1_024
N_SAMPLE = 256
RTOL = ATOL = 1e-5         # fp32 sums in another order than the plain version
# ANN serving: index blocks of 64 items (832 blocks), 104 kept at 0.125
ANN_BLOCK, KEEP_PRUNED, CACHE_ROWS = 64, 0.125, 4096
ANN_TOPOLOGY = "h100-hbm-host"
BOTH_SLOW = {"serve/user_embed": "slow", "serve/item_embed": "slow"}
N_SAMPLE_BATCHES = 8
H2D_BYTES = 256 << 20
# NGCF FULL training: target batch 150,528 in 2 microbatches, 3 steps
TARGET_BATCH, MICROBATCH, TRAIN_STEPS = 150_528, 75_264, 3
# Depth cut: the reference's NGCF sums messages without degree
# normalisation, and each layer's Hadamard term multiplies two aggregated
# embeddings, so activations grow about quadratically per layer over
# rows of up to 256k edges; with 3 layers the first backward overflows
# float32 on this graph (gradients inf/NaN), with 2 it stays finite.
TRAIN_LAYERS = 2
GRAD_RTOL = 1e-4           # per gradient leaf, relative in the norm
# the api phase: LightGCN-FULL (the lightgcn-full preset with the training
# phase's microbatch) for API_STEPS steps through Run.fit; Run.recommend for
# N_RECOMMEND held-out users; the CPU-sized presets against the CPU's plain
# route, loss trajectories within API_RTOL
API_STEPS, N_RECOMMEND = 3, 256
API_PRESETS = ("quickstart", "lightgcn-smoke")
API_RTOL = 1e-4
# the tiered_train phase: LightGCN FULL (the lightgcn-full preset as it is,
# so the planner derives the microbatch) for TIERED_STEPS steps through
# Run.fit in each arm on h100-hbm-host; the reference's derive_microbatch
# and derive_eval_batch give FULL_MICROBATCH (the target batch) and
# FULL_EVAL_BATCH (the cap) for both *-full presets
# steps 0 and 1 of a demoted arm pin fresh host memory for their commits
# (the caching host allocator has none to hand out yet, as the initial
# and the previous state still hold theirs); from step TIERED_STEADY on
# it reuses freed blocks, so the arms compare medians of those steps
TIERED_STEPS, TIERED_STEADY, TIERED_TOPOLOGY = 5, 2, "h100-hbm-host"
FULL_MICROBATCH, FULL_EVAL_BATCH = 150_528, 4_096
# The reference states its compression tolerances on the smoke presets'
# schedule: no warm-up and the base batch at the target, so lr 1e-3 a
# step.  The FULL preset's warm-up scales lr linearly to 0.147 at 150,528
# samples, where one Adam step moves every touched weight by ~0.15, the
# loss swings by ~0.1 a step and a compressed step (int8 rounding, 1 % of
# the gradient) lands elsewhere; so the arms held to those tolerances run
# on the smoke schedule, against an A of that schedule, and are only
# reported at the preset's own lr.
SMOKE_SCHEDULE = {"plan.base_batch": TARGET_BATCH, "plan.warmup_epochs": 0}
DEMOTED = {"memory.pins": {"_embed": "host"}}
INT8_STORE = {**DEMOTED, "compression.embed_store": "int8"}
INT8_GRADS = {"compression.grads": "int8"}
TOPK_GRADS = {"compression.grads": "topk", "compression.frac": 0.01}
TIERED_ARMS = {
    "A_device": {},
    # both tables and their Adam m and v (6 leaves) in pinned host memory
    "B_demoted_fp32": DEMOTED,
    "C_demoted_int8_preset_lr": INT8_STORE,
    "A_lr_1e-3": SMOKE_SCHEDULE,
    "C_demoted_int8": {**SMOKE_SCHEDULE, **INT8_STORE},
    "D_grads_int8": {**SMOKE_SCHEDULE, **INT8_GRADS},
    "D_grads_topk": {**SMOKE_SCHEDULE, **TOPK_GRADS},
    "D_grads_int8_preset_lr": INT8_GRADS,
    "D_grads_topk_preset_lr": TOPK_GRADS,
}
# each arm's comparator, and the (rtol, atol) its losses are held to there:
# the reference's own (tests/test_compression.py:311-321, :339); None is
# reported only; B must be bitwise equal to A
TIERED_VS = {"B_demoted_fp32": ("A_device", "bitwise"),
             "C_demoted_int8_preset_lr": ("A_device", None),
             "C_demoted_int8": ("A_lr_1e-3", (2e-2, 5e-3)),
             "D_grads_int8": ("A_lr_1e-3", (1e-3, 1e-4)),
             "D_grads_topk": ("A_lr_1e-3", (5e-3, 2e-3)),
             "D_grads_int8_preset_lr": ("A_device", None),
             "D_grads_topk_preset_lr": ("A_device", None)}
# the sharded phase: the lightgcn-full preset (tiered_train's microbatch)
# through Run.fit for SHARDED_STEPS steps per arm, in a one-rank NCCL group:
# the kernel route, the ring at one shard, and the ring with its int8
# payload (bit for bit the fp32 ring: one bucket, read exact); the losses
# held to the reference's sharded tolerance (tests/test_distributed.py:284);
# step times are medians from step TIERED_STEADY on (the host clock reads
# an occasional step at several times its neighbours)
SHARDED_STEPS = 5
SHARDED_RTOL, SHARDED_ATOL = 5e-3, 1e-5
SHARDED_ARMS = {"kernel": {}, "ring": {"mesh.spmm": "ring"},
                "ring_int8": {"mesh.spmm": "ring", "compression.ring": "int8"}}
# seed COO path: O0's backward keeps ~5 [E, D] tensors per layer, so O0 is
# timed against O3 on the first 2^22 train edges; the cells' step uses the
# reference cells' optimizer (src/repro/launch/cells.py:36: adam(1e-4))
PREFIX_EDGES = 1 << 22
CELLS_LR = 1e-4
# Fig 5's O1 row is the unkernelized one: levels 1-3 route their sddmm by
# impl (as the reference's do), so O1 asks for the plain route here and
# O2/O3 take the default, the kernel
LEVEL_IMPL = {1: "torch"}
# subgraph baseline (examples/fullgraph_vs_subgraph.py): fanout 10, 2
# workers, 256 seeds; the full-graph arm takes a 256-sample BPR batch
SUB_FANOUT, SUB_WORKERS, SUB_BATCH = 10, 2, 256
# H100 SXM datasheet peaks (NVIDIA, dense, without sparsity)
PEAK_FP32 = 67e12          # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12       # bytes/s, HBM3

TOLERANCE = {
    "spmm_csr": f"adversarial: allclose rtol={RTOL} atol={ATOL}; row-split "
                f"cases and main: |err| <= {ATOL} + {RTOL} * sum of |terms| "
                "per element (max: exact); repeated calls bitwise",
    "embedding_bag": "bitwise (sum and mean, L = 1 to 8, masked and "
                     "unmasked, int32 and int64 ids)",
    "fused_topk_score": "ids and scores bitwise on integer-valued inputs; "
                        f"else scores allclose rtol={RTOL} atol={ATOL} and "
                        "ids equal except at near-ties",
    "hadamard_spmm": "bitwise on integer-valued inputs (row-split cases "
                     "included, epilogue on and off); adversarial: "
                     f"allclose rtol={RTOL} atol={ATOL}; row-split cases and "
                     f"main: |err| <= {ATOL} + {RTOL} * sum of |terms| per "
                     "element; repeated calls bitwise",
    "ann_block_scores": "bitwise on integer-valued users (radius on and "
                        f"off); else allclose rtol={RTOL} atol={ATOL}",
    "sddmm": "bitwise on integer-valued inputs and on 'mul' at the main "
             "shape, walking user groups or the edge order, and grouped "
             f"equal to ungrouped; else allclose rtol={RTOL} atol={ATOL} "
             "('dot' and its sampled_addmm yardstick)",
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
    "ann_block_scores": ("src/repro_torch/kernels/csrc/ann_block_scores.cu",
                         "src/repro/kernels/ann.py:41"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm.py:79"),
}
# the kernels each main path runs
SERVING_KERNELS = ("spmm_csr", "embedding_bag", "fused_topk_score")
ANN_KERNELS = ("embedding_bag", "fused_topk_score", "ann_block_scores")
TRAINING_KERNELS = ("spmm_csr", "hadamard_spmm")
COO_KERNELS = ("sddmm",)
API_KERNELS = ("spmm_csr", "embedding_bag", "fused_topk_score")
TIERED_KERNELS = ("spmm_csr", "embedding_bag", "fused_topk_score")
SHARDED_KERNELS = ("spmm_csr", "embedding_bag", "fused_topk_score")
# spmm_csr's row-split cases (check_spmm); gathered rows come from a table
# of SPLIT_SRC_ROWS rows
SPLIT_CASES = ("long_row", "boundaries", "no_edges", "long_indptr")
SPLIT_SRC_ROWS = 500


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


def device_ms(torch, fn, reps: int = 100) -> float:
    """Device time per call, without the host's launch path: ``reps``
    calls captured once in a CUDA graph and replayed between CUDA events
    (mean of 5 replays)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    stop.synchronize()
    del graph
    return start.elapsed_time(stop) / (5 * reps)


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host time per call (µs): ``calls`` back-to-back calls on a host
    clock, without waiting for the device; what the caller's thread
    spends in the wrapper and the launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


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
    0), zero edges, ragged per-edge values; then the row split's cases
    (``split_graph``), each for sum and max, gather on and off, each
    called twice and required bitwise equal."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmm import CHUNK as SPMM_CHUNK
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
    for case in SPLIT_CASES:
        indptr, n, src = split_graph(case, rng, SPMM_CHUNK)
        for gather in (True, False):
            rows = SPLIT_SRC_ROWS if gather else len(src)
            v = torch.from_numpy(rng.standard_normal((rows, EMBED_DIM))
                                 .astype(np.float32)).to(dev)
            args = (torch.from_numpy(indptr).to(dev),
                    torch.from_numpy(src).to(dev), n)
            empty = torch.from_numpy(np.diff(indptr[:n + 1]) == 0).to(dev)
            for reduce in ("sum", "max"):
                what = f"spmm_csr split {case} {reduce} gather={gather}"
                got = ops.spmm_csr(reduce, v, *args, gather=gather,
                                   impl="cuda")
                again = ops.spmm_csr(reduce, v, *args, gather=gather,
                                     impl="cuda")
                require(torch.equal(got, again), f"{what}: two calls differ")
                want = ref.spmm_csr_ref(reduce, v, *args, gather=gather)
                if reduce == "max":
                    require(torch.equal(got, want), f"{what}: max not exact")
                else:
                    abs_sum = ref.spmm_csr_ref("sum", v.abs(), *args,
                                               gather=gather)
                    worst = max(worst, close_sum(torch, got, want, abs_sum,
                                                 what))
                require(bool((got[empty] == 0).all()),
                        f"{what}: empty row != 0")
    return worst


def split_graph(case, rng, t):
    """(indptr i64, n_nodes, src i32) for the row-split cases, T = the
    kernel's chunk ``t``: 'long_row' one row of 120,000 edges (> 50 % of
    E) in a Zipf graph with trailing empty rows; 'boundaries' rows of T - 1, T and
    T + 1 edges, empty rows, a row that starts exactly on a chunk
    boundary (merge position indptr[v] + v a multiple of T) and trailing
    empty rows; 'no_edges' E = 0; 'long_indptr' the boundaries graph
    called with 3 rows fewer than its indptr holds."""
    degs = [t - 1, t, t + 1, 0, 0, 5]
    degs.append((-(sum(degs) + len(degs) + 1)) % t)
    degs += [3 * t, 1, 0, t - 1, 0, 0]
    n = len(degs)
    if case == "long_row":
        degs = rng.zipf(1.5, 2000).clip(0, 500)
        degs[17] = 120_000
        degs[-5:] = 0
        n = len(degs)
    elif case == "no_edges":
        degs = [0] * (2 * t + 3)
        n = len(degs)
    elif case == "long_indptr":
        degs += [t + 1, 7, 2 * t]
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    src = rng.integers(0, SPLIT_SRC_ROWS, int(indptr[-1])).astype(np.int32)
    if case == "long_row":
        require(degs[17] * 2 > indptr[-1], "long row holds <= 50 % of E")
    if case == "boundaries":
        starts = indptr[:-1] + np.arange(n)
        require(((starts % t == 0) & (np.diff(indptr) > 0))[1:].any(),
                "no row starts on a chunk boundary")
    return indptr, n, src


def check_embedding_bag(torch, dev, rng) -> float:
    """L > 1 with a mask (one bag fully masked), without a mask, int32 and
    int64 ids, sum and mean, D % 4 != 0: bitwise against the plain
    version (both sum each bag's slots in slot order)."""
    from repro_torch.kernels import ops, ref
    for v, b, l, d in [(1000, 300, 5, 128), (17, 5, 3, 100), (33, 7, 2, 130),
                       (9, 1, 4, 37), (1000, 256, 1, 128), (1000, 256, 8, 128)]:
        table = torch.from_numpy(
            rng.standard_normal((v, d)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, v, (b, l)).astype(np.int32)).to(dev)
        mask_np = rng.random((b, l)) > 0.4
        mask_np[0, :] = False
        mask = torch.from_numpy(mask_np).to(dev)
        for combiner in ("sum", "mean"):
            for m in (mask, None):
                want = ref.embedding_bag_ref(table, ids, m, combiner)
                for i in (ids, ids.long()):
                    got = ops.embedding_bag(table, i, m, combiner,
                                            impl="cuda")
                    require(torch.equal(got, want),
                            f"embedding_bag {combiner} L={l} d={d} "
                            f"{i.dtype} mask={m is not None}: not bitwise "
                            "equal to the plain version")
            got = ops.embedding_bag(table, ids, mask, combiner, impl="cuda")
            require(bool((got[0] == 0).all()), "embedding_bag empty bag != 0")
    return 0.0


def itemise_embedding_bag(torch, table, ids, calls: int = 10_000) -> dict:
    """Host µs per piece of ``embedding_bag``'s launch path at the main
    path's call (``ids`` [B, 1], no mask), each over ``calls`` calls on a
    host clock, with the alternatives each piece was chosen over: the
    checks, the output's allocation (``new_empty`` against
    ``torch.empty``), the stream query (``_build.stream_of`` against a
    ``torch.cuda.current_stream`` object), the cached C call with its
    launch, the whole wrapper, and ``_gather_rows`` as the main path calls
    it."""
    from repro_torch.eval.topk import _gather_rows
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import (check_inputs,
                                                   embedding_bag_cuda)
    b, bag_len = ids.shape
    d = table.shape[1]
    out = table.new_empty((b, d))
    fn = _build.entry("embedding_bag", "embedding_bag_f32")
    args = (table.data_ptr(), ids.data_ptr(), None, out.data_ptr(), b,
            bag_len, d, 0, 1, int(ids.dtype is torch.int64),
            *_build.stream_of(table))
    flat = ids[:, 0]
    return {
        "checks": host_us(torch, lambda: check_inputs(table, ids, None),
                          calls),
        "new_empty": host_us(torch, lambda: table.new_empty((b, d)), calls),
        "torch_empty": host_us(torch, lambda: torch.empty(
            (b, d), dtype=torch.float32, device=table.device), calls),
        "stream_of": host_us(torch, lambda: _build.stream_of(table), calls),
        "current_stream_object": host_us(
            torch, lambda: torch.cuda.current_stream(table.device).cuda_stream,
            calls),
        "ctypes_call_with_launch": host_us(torch, lambda: fn(*args), calls),
        "wrapper": host_us(torch, lambda: embedding_bag_cuda(table, ids, None),
                           calls),
        "gather_rows": host_us(torch, lambda: _gather_rows(table, flat,
                                                           "cuda"), calls)}


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
    elif case == "k_max":                     # the old cap of the kernel
        k, ni = 256, 3000
        ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
    elif case in ("k_300", "k_2000"):         # past it, with forced ties
        k, ni = (300, 3000) if case == "k_300" else (2000, 5000)
        ie = np.repeat(rng.integers(-2, 3, (ni // 3 + 1, d))
                       .astype(np.float32), 3, axis=0)[:ni]
        seen = rng.integers(0, ni, (b, L)).astype(np.int32)
    elif case == "ties_across_splits":        # one tile's rows over and over
        from repro_torch.kernels.topk_score import ITEM_TILE
        b, ni = 70, 4000                      # two user tiles, 32 item tiles
        ue = rng.integers(-2, 3, (b, d)).astype(np.float32)
        ie = np.tile(ie[:ITEM_TILE], (-(-ni // ITEM_TILE), 1))[:ni]
        seen = rng.integers(0, ni, (b, L)).astype(np.int32)
        mask = rng.random((b, L)) < 0.5
    return ue, ie, seen, mask, k, ni


def check_topk(torch, dev, rng) -> float:
    """Integer-valued inputs (ids and scores bitwise): forced ties, -0.0,
    K > catalogue, fully masked users, an empty seen list, D % 4 != 0,
    K = 256 (the old cap), K = 300 and 2,000 with forced ties, ties that
    straddle the kernel's split boundaries; plus real-valued scores
    (near-tie rule)."""
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for case in ("integer_ties", "neg_zero", "k_gt_catalogue", "fully_masked",
                 "ragged_d", "empty_seen", "k_max", "k_300", "k_2000",
                 "ties_across_splits", "float"):
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
    return max(worst, check_hadamard_split(torch, dev, rng))


def check_hadamard_split(torch, dev, rng) -> float:
    """The row split on ``split_graph``'s cases at the kernel's chunk (a
    real-valued Zipf graph whose longest row holds 120,000 edges, rows of
    T - 1, T and T + 1 edges, a row on a chunk boundary, empty and trailing
    rows, E = 0, an over-long indptr), general and ``y_is_dst`` indices,
    integer- and real-valued, with and without the epilogue (negative
    scales included): integers bitwise, reals within ATOL + RTOL x the sum
    of |terms|; every call made twice and required bitwise equal."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hadamard_spmm import CHUNK
    worst = 0.0
    for case in SPLIT_CASES:
        indptr, n, x_idx = split_graph(case, rng, CHUNK)
        n_y = len(indptr) - 1
        if case == "long_row":
            require(int(np.diff(indptr).max()) >= 100_000,
                    "hadamard long row holds < 100,000 edges")
        empty = torch.from_numpy(np.diff(indptr[:n + 1]) == 0).to(dev)
        for structure in ("general", "y_is_dst"):
            y_idx = (np.repeat(np.arange(n_y), np.diff(indptr))
                     if structure == "y_is_dst"
                     else rng.integers(0, n_y, len(x_idx))).astype(np.int32)
            args = (torch.from_numpy(indptr).to(dev),
                    torch.from_numpy(x_idx).to(dev),
                    torch.from_numpy(y_idx).to(dev), n)
            for integer in (True, False):
                if integer:
                    x, y, scale = (rng.integers(-3, 4, shape).astype(np.float32)
                                   for shape in ((SPLIT_SRC_ROWS, EMBED_DIM),
                                                 (n_y, EMBED_DIM), n))
                else:
                    x, y, scale = (rng.standard_normal(shape).astype(np.float32)
                                   for shape in ((SPLIT_SRC_ROWS, EMBED_DIM),
                                                 (n_y, EMBED_DIM), n))
                x, y, scale = (torch.from_numpy(a).to(dev)
                               for a in (x, y, scale))
                for epi in (False, True):
                    kw = dict(scale=scale, slope=0.2) if epi else {}
                    what = (f"hadamard_spmm split {case} {structure} "
                            f"integer={integer} epilogue={epi}")
                    got = ops.hadamard_spmm(x, y, *args, impl="cuda", **kw)
                    again = ops.hadamard_spmm(x, y, *args, impl="cuda", **kw)
                    require(torch.equal(got, again), f"{what}: two calls differ")
                    want = ref.hadamard_spmm_ref(x, y, *args, **kw)
                    if integer:
                        require(torch.equal(got, want),
                                f"{what}: not bitwise on integers")
                    else:
                        abs_kw = dict(scale=scale.abs()) if epi else {}
                        abs_sum = ref.hadamard_spmm_ref(x.abs(), y.abs(), *args,
                                                        **abs_kw)
                        worst = max(worst, close_sum(torch, got, want, abs_sum,
                                                     what))
                    require(bool((got[empty] == 0).all()),
                            f"{what}: empty row != 0")
    return worst


def check_ann(torch, dev, rng) -> float:
    """Ragged B, nb and D, nb = 1, the service batch and a whole-sweep B
    against 832 blocks; radius on and off; integer-valued users bitwise."""
    from repro_torch.kernels import ops, ref
    worst = 0.0
    for b, nb, d in [(1, 1, 8), (7, 13, 37), (64, 130, 128), (37, 1, 100),
                     (64, 832, 128), (16_384, 832, 128)]:
        for integer in (True, False):
            ue = rng.integers(-3, 4, (b, d)) if integer \
                else rng.standard_normal((b, d))
            args = [torch.from_numpy(a).to(dev) for a in (
                ue.astype(np.float32),
                rng.integers(-127, 128, (nb, d)).astype(np.int8),
                (rng.random(nb) / 50).astype(np.float32),
                rng.random(nb).astype(np.float32))]
            for radius in (args[3], torch.zeros_like(args[3])):
                got = ops.ann_block_scores(*args[:3], radius, impl="cuda")
                want = ref.ann_block_scores_ref(*args[:3], radius)
                torch.cuda.synchronize()
                what = f"ann_block_scores B={b} nb={nb} d={d}"
                if integer:
                    require(torch.equal(got, want),
                            f"{what}: not bitwise on integers")
                else:
                    worst = max(worst, close(torch, got, want, what))
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
    from repro_torch.kernels import ops, ref, row_split
    from repro_torch.kernels.embedding_bag import noop_cuda
    from repro_torch.kernels.spmm import CHUNK
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
                        "longest_row": int((ip[1:n + 1] - ip[:n]).max()),
                        "chunk": CHUNK,
                        "chunks": row_split.n_chunks(n, src.numel(), CHUNK),
                        "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                        "gathered_row_bytes": src.numel() * x.shape[1] * 4})
    b_ms, b_by = bound(bytes_, flops)
    out["spmm_csr"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by, per_direction=per_dir,
                           work=f"one layer: agg_u2i + agg_i2u, D={EMBED_DIM}")

    # embedding_bag: the user-row gather of one 256-user batch (L = 1), as
    # _gather_rows makes it: the batch's int32 ids, no mask
    users = torch.from_numpy(eval_users[:USER_BATCH]).to(dev)
    ids = users.to(torch.int32)[:, None].contiguous()
    got = _gather_rows(user_f, users, "cuda")
    want = ref.embedding_bag_ref(user_f, ids, None, "sum")
    require(torch.equal(got, want),
            "embedding_bag main: not bitwise equal to the plain version")
    errs["embedding_bag"] = max(errs["embedding_bag"], max_err(got, want))
    ids64 = ids.long()

    def bag_kernel():
        return ops.embedding_bag(user_f, ids, None, "sum", impl="cuda")

    def bag_library():
        return torch.nn.functional.embedding_bag(ids64, user_f, mode="sum")

    t_k = cuda_ms(torch, bag_kernel, reps=50)
    t_p = cuda_ms(torch, lambda: ref.embedding_bag_ref(user_f, ids, None,
                                                       "sum"), reps=50)
    t_l = cuda_ms(torch, bag_library, reps=50)
    b_ms, b_by = bound(ids.numel() * EMBED_DIM * 4 + ids.numel() * 4
                       + ids.numel() * EMBED_DIM * 4, ids.numel() * EMBED_DIM)

    def noop():
        return noop_cuda(user_f)

    out["embedding_bag"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
        device_ms=device_ms(torch, bag_kernel),
        library_device_ms=device_ms(torch, bag_library),
        host_us_per_call=host_us(torch, bag_kernel, 10_000),
        library_host_us_per_call=host_us(torch, bag_library, 10_000),
        launch_floor_device_ms=device_ms(torch, noop),
        launch_floor_host_us=host_us(torch, noop, 10_000),
        host_path_us=itemise_embedding_bag(torch, user_f, ids),
        timing="ms: 50 Python calls between CUDA events; device_ms: 100 "
               "calls captured in a CUDA graph and replayed; "
               "host_us_per_call: 10,000 calls on a host clock; "
               "launch_floor: an empty kernel (repro_noop) through the "
               "same launch path; host_path_us: each piece of the "
               "wrapper's host path over 10,000 calls",
        work=f"B={ids.shape[0]} L=1 D={EMBED_DIM}, int32 ids, no mask")

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
    t_y = cuda_ms(torch, topk_yardstick(torch, ue, item_f, seen, smask), reps=10)
    b_ms, b_by = bound(ue.numel() * 4 + item_f.numel() * 4 + seen.numel() * 5
                       + 2 * ue.shape[0] * K * 4,
                       2.0 * ue.shape[0] * N_ITEMS * EMBED_DIM)
    out["fused_topk_score"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        three_call_yardstick="torch.matmul, scatter_ of the seen mask, "
                             "torch.topk (no tie order)",
        yardstick_ms=t_y,
        work=f"B={ue.shape[0]} I={N_ITEMS} D={EMBED_DIM} k={K} "
             f"seen_len={seen.shape[1]}", near_tie_id_swaps=excused)
    for name, rec in out.items():
        detail = {k: v for k, v in rec.items() if k != "ms"}
        emit({"kernel": name, "kernel_ms": rec["ms"], **detail,
              "max_abs_err": errs[name], "tolerance": TOLERANCE[name]})
    return out


def topk_yardstick(torch, ue, table, seen, smask, k=K):
    """The library yardstick of one fused top-K call, timed only: three
    PyTorch calls (``torch.matmul`` into a buffer with one spare column,
    ``scatter_`` of -inf over the live seen ids, ``torch.topk``); the
    spare column takes the padded seen slots.  ``torch.topk`` promises no
    tie order, so it computes the same set up to ties, not the kernel's
    (score desc, id asc) order."""
    n = table.shape[0]
    padded = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    cols = torch.where(smask, seen.long(), n)
    buf = torch.empty((ue.shape[0], n + 1), device=ue.device)

    def call():
        torch.matmul(ue, padded.T, out=buf)
        buf.scatter_(1, cols, float("-inf"))
        return torch.topk(buf[:, :n], k, dim=1)

    return call


def large_k_routes(torch, g, test, user_f, item_f, index, eval_users):
    """k = 300, past the kernel's old cap of 256, on the card: the
    streaming top-K's fused route and ``ann_topk`` at keep 1.0 over the
    first LARGE_K_USERS held-out users, each against the block-major route
    on the card (ids equal except at near-ties), and
    ``evaluate_embeddings`` over all held-out users."""
    from repro_torch import kernels
    from repro_torch.data import synth
    from repro_torch.eval import evaluate_embeddings
    from repro_torch.eval.topk import streaming_topk
    from repro_torch.serving import ann_topk
    seen_ip, seen_it = g.seen_csr()
    kw = dict(user_ids=np.asarray(eval_users[:LARGE_K_USERS], np.int32),
              seen_indptr=seen_ip, seen_items=seen_it, user_batch=USER_BATCH,
              item_block=ITEM_BLOCK)
    before = kernels.launch_counts()["fused_topk_score"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_f, i_f = streaming_topk(user_f, item_f, LARGE_K, **kw)
    fused_s = time.perf_counter() - t0
    require(kernels.launch_counts()["fused_topk_score"] > before,
            "streaming_topk at k=300 did not launch the kernel")
    t0 = time.perf_counter()
    s_b, i_b = streaming_topk(user_f, item_f, LARGE_K, fused=False, **kw)
    block_s = time.perf_counter() - t0
    swaps_f = topk_agree(s_f, i_f, s_b, i_b,
                         f"streaming_topk k={LARGE_K} fused vs block-major")
    before = kernels.launch_counts()["fused_topk_score"]
    t0 = time.perf_counter()
    s_a, i_a = ann_topk(index, user_f, item_f, LARGE_K, keep_frac=1.0, **kw)
    ann_s = time.perf_counter() - t0
    require(kernels.launch_counts()["fused_topk_score"] > before,
            "ann_topk at k=300 did not launch the kernel")
    swaps_a = topk_agree(s_a, i_a, s_b, i_b,
                         f"ann_topk k={LARGE_K} keep 1.0 vs block-major")
    require(bool((i_f >= 0).all()), f"streaming_topk k={LARGE_K}: short "
                                    "slots on a full catalogue")
    test_pos = synth.group_by_user(test.user, test.item, N_USERS)
    keep = np.zeros(N_USERS, bool)
    keep[eval_users] = True
    empty = np.zeros(0, np.int64)
    eval_pos = [p if keep[u] else empty for u, p in enumerate(test_pos)]
    t0 = time.perf_counter()
    metrics = evaluate_embeddings(user_f, item_f, eval_pos, k=LARGE_K,
                                  seen_indptr=seen_ip, seen_items=seen_it,
                                  user_batch=USER_BATCH, item_block=ITEM_BLOCK)
    eval_s = time.perf_counter() - t0
    require(all(0.0 <= v <= 1.0 for v in metrics.values()),
            f"k={LARGE_K} metrics out of [0, 1]: {metrics}")
    emit({"phase": "large_k", "k": LARGE_K, "users": len(kw["user_ids"]),
          "streaming_fused_s": fused_s, "streaming_block_major_s": block_s,
          "ann_keep_all_s": ann_s, "fused_near_tie_id_swaps": swaps_f,
          "ann_near_tie_id_swaps": swaps_a,
          "evaluate_users": int(len(eval_users)), "evaluate_s": eval_s,
          "metrics": metrics})


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


def check_valid(responses, users, seen_ip, seen_it) -> None:
    """Every request answered in order with K valid, unique, unseen ids in
    (score desc, id asc) order and finite scores."""
    require(len(responses) == len(users), "lost requests")
    require([r.user_id for r in responses] == [int(u) for u in users],
            "responses out of order")
    for r in responses:
        ids, scores = np.asarray(r.ids), np.asarray(r.scores)
        require(ids.shape == (K,) and ((ids >= 0) & (ids < N_ITEMS)).all(),
                f"user {r.user_id}: not {K} valid ids")
        require(len(np.unique(ids)) == K, f"user {r.user_id}: repeated ids")
        ordered = (scores[:-1] > scores[1:]) | (
            (scores[:-1] == scores[1:]) & (ids[:-1] < ids[1:]))
        require(np.isfinite(scores).all() and ordered.all(),
                f"user {r.user_id}: not finite, in (score desc, id asc)")
        seen = seen_it[seen_ip[r.user_id]:seen_ip[r.user_id + 1]]
        require(not np.isin(ids, seen).any(),
                f"user {r.user_id}: recommended a seen item")


def check_responses(torch, responses, users, rec, seen_ip, seen_it):
    from repro_torch.eval.topk import streaming_topk
    check_valid(responses, users, seen_ip, seen_it)
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
    return user_f, item_f, launches, eval_users, responses, users


# ------------------------------------------------------------------ phase 5
class Recording:
    """A Recommender as the service sees it, keeping every batch it is
    asked for with its answer (to replay the same batches elsewhere)."""

    def __init__(self, rec):
        self.rec, self.k, self.batches = rec, rec.k, []

    def recommend(self, user_ids, k=None):
        ids, scores = self.rec.recommend(user_ids, k=k)
        self.batches.append((np.array(user_ids), ids, scores))
        return ids, scores

    def cache_stats(self):
        return self.rec.cache_stats()

    def describe(self):
        return self.rec.describe()


def serve_requests(torch, rec, users):
    """The main path's 1,024 requests through a ``RecommenderService`` under
    a ``ManualClock``; returns (responses, stats, recorded batches,
    wall seconds).  Batches depend on each batch's measured compute."""
    from repro_torch.serving import ManualClock, RecommenderService
    rr = Recording(rec)
    clock = ManualClock()
    svc = RecommenderService(rr, max_batch=MAX_BATCH, max_wait_us=MAX_WAIT_US,
                             clock=clock)
    responses = []
    t0 = time.perf_counter()
    for uid in users:
        clock.advance(ARRIVAL_US)
        svc.submit(int(uid))
        responses.extend(svc.poll())
    responses.extend(svc.drain())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = svc.stats()
    require(stats["completed"] == len(users) and stats["rejected"] == 0,
            "service dropped requests")
    return responses, stats, rr.batches, wall


def replay_equal(rec, batches, what: str) -> None:
    """``rec`` answers every recorded batch bit for bit as recorded."""
    for uids, ids, scores in batches:
        got_ids, got_scores = rec.recommend(uids)
        require(np.array_equal(got_ids, ids)
                and np.array_equal(got_scores, scores),
                f"{what}: a batch differs bitwise")


def selection_differs(torch, rec, uids) -> bool:
    """Whether the kernel's and the plain version's affinities keep
    different blocks for this batch (a near-tie at the cut)."""
    from repro_torch.eval.recommender import _served_rows
    index = rec.ann_index
    ue = torch.from_numpy(_served_rows(rec.user_e)[uids]).to(index.device)
    kept = [index.select_blocks(index.block_affinity(ue, len(uids), impl),
                                rec.keep_frac) for impl in ("cuda", "torch")]
    return not np.array_equal(*kept)


def ann_serving(torch, g, user_f, item_f, users, exact):
    """Four runs over the main path's final embeddings and requests; each
    run's launches are counted from 0 around its service drive only."""
    from repro_torch import kernels
    from repro_torch.eval import Recommender
    from repro_torch.memory import HostResident, HotRowCache, get_topology
    from repro_torch.serving import recall_against
    seen_ip, seen_it = g.seen_csr()
    base = dict(seen_indptr=seen_ip, seen_items=seen_it, k=K,
                item_block=ITEM_BLOCK, user_batch=USER_BATCH, device=g.device,
                ann=True, ann_block=ANN_BLOCK, topology=ANN_TOPOLOGY)
    runs = {
        "device_keep_all": dict(keep_frac=1.0),
        "device_pruned": dict(keep_frac=KEEP_PRUNED),
        "tiered_fp32": dict(keep_frac=KEEP_PRUNED, pins=BOTH_SLOW,
                            cache_rows=CACHE_ROWS),
        "tiered_int8": dict(keep_frac=KEEP_PRUNED, pins=BOTH_SLOW,
                            cache_rows=CACHE_ROWS, embed_store="int8"),
    }
    total = {name: 0 for name in KERNELS}
    recs, out = {}, {}
    for name, knobs in runs.items():
        t0 = time.perf_counter()
        rec = Recommender(user_f, item_f, **base, **knobs)
        build_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        responses, stats, batches, wall = serve_requests(torch, rec, users)
        launches = kernels.launch_counts()
        for k_, v in launches.items():
            total[k_] += v
        require(launches["ann_block_scores"] > 0,
                f"{name}: ann_block_scores never launched")
        check_valid(responses, users, seen_ip, seen_it)
        rec_out = {"phase": "ann_serving", "run": name, **knobs,
                   "requests": len(users), "batches": stats["batches"],
                   "service_p50_us": stats["service_p50_us"],
                   "service_p99_us": stats["service_p99_us"],
                   "total_p50_us": stats["total_p50_us"],
                   "total_p99_us": stats["total_p99_us"],
                   "serve_wall_s": wall, "recommender_build_s": build_s,
                   "index_build_s": rec.index_build_s,
                   "index_nbytes": rec.ann_index.nbytes,
                   "kept_blocks": rec.ann_index.n_keep(rec.keep_frac),
                   "n_blocks": rec.ann_index.n_blocks,
                   "launches": launches}
        ids = np.stack([r.ids for r in responses])
        if name == "device_keep_all":
            want_i = np.stack([r.ids for r in exact])
            want_s = np.stack([r.scores for r in exact])
            require(np.array_equal(ids, want_i) and np.array_equal(
                np.stack([r.scores for r in responses]), want_s),
                    "keep_frac=1.0 is not bitwise equal to the exact responses")
            rec_out["bitwise_equal_to"] = "main_path exact responses"
        elif name == "device_pruned":
            # each returned score against the plain u·x on the card
            sample = responses[:N_SAMPLE]
            u = torch.from_numpy(np.array([r.user_id for r in sample])).to(
                g.device).long()
            i = torch.from_numpy(np.stack([r.ids for r in sample])).to(
                g.device).long()
            plain = (user_f[u][:, None, :] * item_f[i]).sum(-1).cpu().numpy()
            got = np.stack([r.scores for r in sample])
            require(np.allclose(got, plain, rtol=RTOL, atol=ATOL),
                    "pruned scores differ from the plain u·x")
            rec_out["recall_at_20_vs_keep_all"] = recall_against(
                out["device_keep_all"]["ids"], ids)
            rec_out["score_max_abs_err_vs_plain"] = float(
                np.abs(got - plain).max())
        else:
            plan_ok = rec.n_offloaded == 2 and all(
                isinstance(t, HotRowCache) and isinstance(t.backing,
                                                          HostResident)
                for t in (rec.user_e, rec.item_e))
            require(plan_ok, f"{name}: tables not demoted behind caches")
            backing = rec.item_e.backing
            host = backing.q if knobs.get("embed_store") == "int8" \
                else backing.arr
            require(host.is_pinned(), f"{name}: host store not pinned")
            rec_out["cache"] = {
                n.split("/")[-1]: {key: st[key] for key in (
                    "hit_rate", "hits", "misses", "bytes_streamed", "fills",
                    "evictions")} for n, st in rec.cache_stats().items()}
            rec_out["link_bytes"] = {
                "user_embed": rec.user_e.link_bytes,
                "item_embed": rec.item_e.link_bytes}
        rec_out["describe"] = rec.describe()
        out[name] = {"ids": ids, "batches": batches, "emit": rec_out}
        recs[name] = rec
        if name == "tiered_fp32":
            # every batch of this run answered by the device tables
            replay_equal(recs["device_pruned"], batches,
                         "tiered fp32 vs device tables")
            rec_out["bitwise_equal_to"] = "device_pruned on the same batches"
        if name == "tiered_int8":
            plain = Recommender(user_f, item_f, **base, **knobs, impl="torch")
            excused = flips = 0
            for uids, b_ids, b_scores in batches[:N_SAMPLE_BATCHES]:
                p_ids, p_scores = plain.recommend(uids)
                try:
                    excused += topk_agree(b_scores, b_ids, p_scores, p_ids,
                                          "tiered int8 vs plain route")
                except SmokeFailure:
                    require(selection_differs(torch, rec, uids),
                            "tiered int8 differs from the plain route "
                            "with the same blocks kept")
                    flips += 1
            rec_out.update(sample_batches_vs_plain=min(N_SAMPLE_BATCHES,
                                                       len(batches)),
                           sample_near_tie_id_swaps=excused,
                           sample_selection_near_ties=flips)
            del plain
        emit(rec_out)
    # the capacity tier's saving: bytes over the host link, int8 vs fp32
    link = {n: sum(out[n]["emit"]["link_bytes"].values())
            for n in ("tiered_fp32", "tiered_int8")}
    h2d = pinned_h2d(torch, g.device)
    emit({"phase": "ann_serving", "link_bytes_fp32": link["tiered_fp32"],
          "link_bytes_int8": link["tiered_int8"],
          "int8_link_saving": 1 - link["tiered_int8"] / link["tiered_fp32"],
          "pinned_h2d_GBps": h2d,
          "topology_host_read_GBps": get_topology(ANN_TOPOLOGY).slow.read_bw
          / 1e9, "h2d_bytes": H2D_BYTES, "launches": total})
    return total, recs["device_pruned"].ann_index


def pinned_h2d(torch, dev) -> float:
    """One 256 MB pinned host-to-device copy, CUDA events (best of 3)."""
    src = torch.empty(H2D_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(H2D_BYTES, dtype=torch.uint8, device=dev)
    best = float("inf")
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return H2D_BYTES / (best * 1e-3) / 1e9


def time_ann(torch, index, user_f, users, errs):
    """``ann_block_scores`` at the serving shape (one full service batch of
    64 users against the 832-block index, the affinity launch) and at the
    whole-sweep shape (16,384 users against the same blocks): kernel,
    plain version and a one-matmul yardstick over dequantized centroids.
    Each is timed per Python call (``cuda_ms``, today's method), on the
    device alone (``device_ms``), and on the host (``host_us``)."""
    from repro_torch.kernels import ops, ref
    dev = user_f.device
    u = torch.from_numpy(np.asarray(users[:MAX_BATCH])).to(dev).long()
    cent = index._cq_dev.float()
    zero = index._zero_dev
    nb = index.n_blocks
    shapes = {}
    for name, ue in (("serving", user_f[u].contiguous()),
                     ("sweep", user_f[:N_EVAL_USERS].contiguous())):
        args = (ue, index._cq_dev, index._scale_dev)
        for radius in (zero, index._radius_dev):
            got = ops.ann_block_scores(*args, radius, impl="cuda")
            want = ref.ann_block_scores_ref(*args, radius)
            errs["ann_block_scores"] = max(errs["ann_block_scores"], close(
                torch, got, want, f"ann_block_scores {name}"))

        def kernel():
            return ops.ann_block_scores(*args, zero, impl="cuda")

        def library():
            return torch.matmul(ue, cent.T)

        b, d = ue.shape
        b_ms, b_by = bound(b * d * 4 + nb * d + nb * 8 + b * nb * 4,
                           2.0 * b * nb * d + 3.0 * b * nb + 2.0 * b * d)
        shapes[name] = dict(
            ms=cuda_ms(torch, kernel, reps=100),
            plain_ms=cuda_ms(torch, lambda: ref.ann_block_scores_ref(
                *args, zero), reps=100),
            library_ms=cuda_ms(torch, library, reps=100),
            device_ms=device_ms(torch, kernel),
            library_device_ms=device_ms(torch, library),
            host_us_per_call=host_us(torch, kernel),
            library_host_us_per_call=host_us(torch, library),
            bound_ms=b_ms, bound_by=b_by, work=f"B={b} nb={nb} D={d}")
    rec = dict(shapes["serving"], sweep=shapes["sweep"],
               yardstick="torch.matmul(ue, float(centroids_q).T)",
               timing="ms: 100 Python calls between CUDA events; device_ms: "
                      "100 calls captured in a CUDA graph and replayed; "
                      "host_us_per_call: 1,000 calls on a host clock")
    emit({"kernel": "ann_block_scores", "kernel_ms": rec["ms"],
          **{k: v for k, v in rec.items() if k != "ms"},
          "max_abs_err": errs["ann_block_scores"],
          "tolerance": TOLERANCE["ann_block_scores"]})
    return rec


# ------------------------------------------------------------------ phase 6

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


# ------------------------------------------------------------------ api
def _leaves_equal(torch, a, b) -> bool:
    from repro_torch.optim.optimizers import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _timed_saves(saves):
    """The loop's ``save_checkpoint``, timed: each save's seconds and the
    bytes it wrote."""
    from repro_torch.runtime import loop as loop_mod
    save = loop_mod.save_checkpoint

    def timed(ckpt_dir, step, tree, async_=False):
        t0 = time.perf_counter()
        writer = save(ckpt_dir, step, tree, async_=async_)
        if writer is not None:
            writer.join()
        step_dir = pathlib.Path(ckpt_dir) / f"step_{step}"
        saves.append({"step": step, "s": time.perf_counter() - t0,
                      "bytes": sum(f.stat().st_size
                                   for f in step_dir.iterdir())})
        return None

    return loop_mod, save, timed


class StepTimer:
    """A ``Pipeline.step_context`` that times each step the loop drives
    (host clock between two synchronisations) and reads the device memory
    allocated as each step begins."""

    def __init__(self, torch, inner):
        self.torch, self.inner, self.ms, self.mem = torch, inner, [], []

    def __call__(self):
        return self

    def __enter__(self):
        self.ctx = self.inner()
        self.ctx.__enter__()
        self.torch.cuda.synchronize()
        self.mem.append(self.torch.cuda.memory_allocated())
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - self.t0) * 1e3)
        return self.ctx.__exit__(*exc)


def api_presets(torch, dev) -> dict:
    """``quickstart`` and ``lightgcn-smoke`` through ``Run.fit()`` and
    ``Run.evaluate()`` on the card and on the CPU's plain route, from the
    same (the CPU run's) init: loss trajectories within rtol API_RTOL."""
    from repro_torch.api import build, get_preset, load_data
    from repro_torch.optim.optimizers import tree_map
    out = {}
    for name in API_PRESETS:
        spec = get_preset(name)
        train, holdout = load_data(spec.data)
        cpu = build(spec, train=train, holdout=holdout, device="cpu")
        card = build(spec, train=train, holdout=holdout, device=dev)
        card.state = tree_map(lambda t: t.to(dev), cpu.state)
        t0 = time.perf_counter()
        rep = card.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        metrics = card.evaluate()
        want = cpu.fit()
        want_metrics = cpu.evaluate()
        got, ref_l = np.array(rep.losses), np.array(want.losses)
        require(len(got) == spec.loop.steps and np.isfinite(got).all(),
                f"api {name}: {len(got)} losses or non-finite")
        rel = float(np.max(np.abs(got - ref_l) / np.abs(ref_l)))
        require(rel <= API_RTOL, f"api {name}: loss trajectory off the "
                                 f"plain route's by {rel} (rtol {API_RTOL})")
        require(all(0.0 <= v <= 1.0 for v in metrics.values()),
                f"api {name}: metrics out of [0, 1]: {metrics}")
        out[name] = {"steps": len(got), "fit_s": fit_s,
                     "first_loss": float(got[0]), "last_loss": float(got[-1]),
                     "loss_max_rel_err_vs_cpu": rel, "metrics": metrics,
                     "cpu_metrics": want_metrics}
    return out


def api_phase(torch, dev, train, test):
    """LightGCN-FULL through the Experiment API (``Experiment.from_preset``
    -> ``build`` -> ``Run.fit``/``evaluate``/``recommend``) on the smoke's
    graph, a checkpointed run resumed bit for bit, then the CPU-sized
    presets against the plain route.  Returns the launches of the main
    run (fit, evaluate, recommend) and the evaluation's seconds."""
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.api import Experiment
    from repro_torch.eval import Recommender
    exp = Experiment.from_preset("lightgcn-full", {
        "plan.microbatch": MICROBATCH, "loop.steps": API_STEPS})
    spec = exp.spec
    require((spec.model.arch, spec.model.embed_dim, spec.model.n_layers,
             spec.data.n_users, spec.data.n_items,
             spec.plan.target_batch) == ("lightgcn", EMBED_DIM, N_LAYERS,
                                         N_USERS, N_ITEMS, TARGET_BATCH),
            "the lightgcn-full preset is not LightGCN FULL")
    t0 = time.perf_counter()
    run = exp.build(train=train, holdout=test, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the preset's schedule: epoch 0 is a warm-up epoch (target/10), one
    # microbatch of MICROBATCH a step at the linearly scaled LR
    micro = run.pipeline.plan.microbatches_for_epoch(0)
    lr = run.pipeline.lr_for_epoch(0)

    timer = StepTimer(torch, run.pipeline.step_context)
    run.pipeline.step_context = timer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = run.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    del run.pipeline.step_context
    t0 = time.perf_counter()
    metrics = run.evaluate()
    eval_s = time.perf_counter() - t0
    eval_batch = run.pipeline.eval_user_batch()
    users = np.nonzero(np.bincount(test.user, minlength=N_USERS))[0]
    users = users[:N_RECOMMEND]
    t0 = time.perf_counter()
    ids, scores = run.recommend(users)
    recommend_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in API_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the api path")
    losses = report.losses
    require(report.steps_run == API_STEPS and np.isfinite(losses).all(),
            f"api: {report.steps_run} steps, losses {losses}")
    require(all(0.0 <= v <= 1.0 for v in metrics.values()),
            f"api: metrics out of [0, 1]: {metrics}")
    plain = Recommender.from_pipeline(run.pipeline, run.state, impl="torch",
                                      k=spec.eval.k)
    before = kernels.launch_counts()
    p_ids, p_scores = plain.recommend(users)
    require(kernels.launch_counts() == before,
            "the plain route launched a kernel")
    excused = topk_agree(scores, ids, p_scores, p_ids, "api recommend")
    del plain

    # a checkpointed run of 2 steps, then a third run resumed from it for
    # 1 step: the same loss and state as the uninterrupted run, bit for bit
    ck = tempfile.mkdtemp(prefix="api_ckpt_", dir=ROOT / "build")
    saves = []
    loop_mod, save, timed = _timed_saves(saves)
    try:
        first = exp.override({"loop.ckpt_dir": ck, "loop.ckpt_every": 2}) \
            .build(train=train, holdout=test, device=dev)
        loop_mod.save_checkpoint = timed
        try:
            rep2 = first.fit(steps=2)
        finally:
            loop_mod.save_checkpoint = save
        del first
        torch.cuda.empty_cache()
        resumed = exp.build(train=train, holdout=test, device=dev)
        t0 = time.perf_counter()
        resumed.resume(ck)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rep3 = resumed.fit(steps=1)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    require(rep2.losses == losses[:2],
            f"api: the checkpointed run's losses {rep2.losses} differ from "
            f"{losses[:2]}")
    require(rep3.losses == losses[2:],
            f"api: the resumed loss {rep3.losses} differs from {losses[2:]}")
    require(_leaves_equal(torch, resumed.state, run.state),
            "api: the resumed state differs from the uninterrupted run's")
    del resumed
    describe = run.describe().splitlines()[0]
    del run
    torch.cuda.empty_cache()
    presets = api_presets(torch, dev)
    emit({"phase": "api", "preset": "lightgcn-full",
          "overrides": {"plan.microbatch": MICROBATCH,
                        "loop.steps": API_STEPS},
          "describe": describe, "build_s": build_s,
          "microbatches_per_step": micro, "lr": lr, "fit_s": fit_s,
          "ms_per_step": timer.ms, "losses": losses,
          "eval_s": eval_s, "eval_user_batch": eval_batch,
          "metrics": metrics,
          "eval_users": int(len(np.unique(test.user))),
          "recommend_users": int(len(users)), "recommend_s": recommend_s,
          "recommend_near_tie_id_swaps_vs_plain": excused,
          "resume": {"saves": saves, "restore_s": restore_s,
                     "resumed_loss": rep3.losses[0],
                     "bitwise_equal_to_uninterrupted": True},
          "presets": presets, "launches": launches})
    return launches, eval_s


# ------------------------------------------------------------ tiered_train
class LinkTimer:
    """Times an executor's ``fetch`` and ``commit`` with CUDA events: the
    device time of the copies each issues (and, for ``commit``, of the
    int8 store's quantisation), per step."""

    def __init__(self, torch, executor):
        self.torch, self.events = torch, {"fetch": [], "commit": []}
        for name in self.events:
            setattr(executor, name, self._timed(name,
                                                getattr(executor, name)))

    def _timed(self, name, inner):
        def timed(state):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(state)
            end.record()
            self.events[name].append((start, end))
            return out
        return timed

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) for a, b in pairs]
                for name, pairs in self.events.items()}


def _host_leaves(torch, state) -> dict:
    """{path: host copy} of every leaf (the arm A reference)."""
    from repro_torch.optim.optimizers import tree_paths
    return {p: t.detach().cpu() for p, t in tree_paths(state)}


def _free(torch) -> None:
    """Release a dropped run's device memory: a run's pipeline and its
    ``eval_fn`` closure form a reference cycle, so only a collection
    frees it before the next arm's numbers are read."""
    gc.collect()
    torch.cuda.empty_cache()


def tiered_arm(torch, dev, exp, name, train, test):
    """One arm of ``tiered_train``: the arm's spec through ``Run.fit()``,
    timed per loop step, its executor's fetch/commit timed per step and
    its link bytes, memory between steps and peak memory read.  Returns
    (run, record)."""
    run = exp.override({"memory.topology": TIERED_TOPOLOGY,
                        "loop.steps": TIERED_STEPS, **TIERED_ARMS[name]}) \
        .build(train=train, holdout=test, device=dev)
    pipe = run.pipeline
    timer = StepTimer(torch, pipe.step_context)
    pipe.step_context = timer
    links = LinkTimer(torch, pipe.executor)
    pipe.executor.link_bytes = {"h2d": 0, "d2h": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    report = run.fit()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del pipe.step_context
    losses = report.losses
    require(report.steps_run == TIERED_STEPS and np.isfinite(losses).all(),
            f"tiered_train {name}: {report.steps_run} steps, {losses}")
    require(pipe.plan.microbatch == FULL_MICROBATCH,
            f"tiered_train {name}: microbatch {pipe.plan.microbatch}")
    ex = pipe.executor
    int8 = {n: ex.store_nbytes(n) for n in ex._int8}
    link_ms = links.ms()
    rec = {"arm": name, "overrides": TIERED_ARMS[name],
           "n_offloaded": pipe.n_offloaded,
           "demoted": sorted(ex._host_names),
           "demoted_bytes": _demoted_bytes(pipe, run.state),
           "est_penalty_ms": pipe.plan.plan.est_step_penalty_s * 1e3,
           "ms_per_step": timer.ms, "losses": losses,
           "fetch_ms": link_ms["fetch"], "commit_ms": link_ms["commit"],
           "link_bytes_per_step": {k: v / TIERED_STEPS
                                   for k, v in ex.link_bytes.items()},
           "allocated_between_steps": timer.mem,
           "peak_allocated": peak, "int8_store_bytes": int8,
           "describe": run.describe().splitlines()[1],
           "executor": ex.describe()}
    if pipe.compressor is not None:
        rec["compressor"] = pipe.compressor.describe()
        rec["wire_bytes_per_step"] = pipe.compressor.wire_bytes_per_step(
            run.state["params"])
    return run, rec


def _demoted_bytes(pipe, state) -> int:
    """Bytes of the state's leaves in the executor's host store."""
    from repro_torch.optim.optimizers import tree_paths
    return sum(t.numel() * t.element_size()
               for prefix in ("params", "opt")
               for path, t in tree_paths(state[prefix])
               if prefix + path in pipe.executor._host_names)


def padded_seen_ms(torch, dev, g, test, batch) -> dict:
    """``eval/topk.py::_padded_seen`` alone over the held-out users in
    batches of ``batch``, CUDA events: its time and the bytes it builds."""
    from repro_torch.eval.topk import _padded_seen
    indptr, items = g.seen_csr()
    indptr = torch.from_numpy(indptr).to(dev)
    items = torch.from_numpy(items).to(dev)
    users = torch.from_numpy(np.unique(test.user).astype(np.int32)).to(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    built = widest = 0
    start.record()
    for lo in range(0, len(users), batch):
        sel = users[lo:lo + batch]
        deg = indptr[sel.long() + 1] - indptr[sel.long()]
        seen, mask = _padded_seen(sel, indptr, items, int(deg.max()))
        built += seen.numel() * 5
        widest = max(widest, seen.shape[1])
    end.record()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end), "bytes": built,
            "widest": widest, "batches": -(-len(users) // batch)}


def tiered_train(torch, dev, train, test, api_eval_s):
    """The training half of the planner and tiers at LightGCN-FULL width:
    both ``*-full`` presets built as they are (the derived microbatch and
    eval batch), then LightGCN FULL through ``Run.fit()`` in the arms of
    TIERED_ARMS on ``h100-hbm-host`` — B bitwise equal to A, C and D
    within the reference's tolerances of A — and ``Run.evaluate()`` on
    arm B at the derived eval batch.  One graph serves every build: the
    host-side CSR sort (~7.5 s) is set-up, not what the arms compare.
    Returns the phase's launches and that graph."""
    from repro_torch import kernels
    from repro_torch.api import Experiment
    from repro_torch.eval import metrics as metrics_mod
    from repro_torch.pipeline import engine, sparse
    t_phase = time.perf_counter()
    _free(torch)
    graph = sparse.BipartiteCSR(train.user, train.item, train.n_users,
                                train.n_items, device=dev)
    engine.BipartiteCSR = lambda *a, **kw: graph
    try:
        presets = {}
        for name in ("lightgcn-full", "ngcf-full"):
            run = Experiment.from_preset(name).build(train=train,
                                                     holdout=test,
                                                     device=dev)
            presets[name] = {"describe": run.describe(),
                             "microbatch": run.pipeline.plan.microbatch,
                             "eval_user_batch":
                                 run.pipeline.eval_user_batch()}
            require(presets[name]["microbatch"] == FULL_MICROBATCH
                    and presets[name]["eval_user_batch"] == FULL_EVAL_BATCH,
                    f"{name}: derived {presets[name]}")
            del run
            _free(torch)
        exp = Experiment.from_preset("lightgcn-full")
        kernels.reset_launch_counts()
        arms, finals = {}, {}
        for name in TIERED_ARMS:
            run, rec = tiered_arm(torch, dev, exp, name, train, test)
            arms[name] = rec
            if name.startswith("A_"):
                finals[name] = _host_leaves(torch, run.state)
                del run
                _free(torch)
                continue
            vs, tol = TIERED_VS[name]
            want = arms[vs]["losses"]
            err = np.abs(np.array(rec["losses"]) - np.array(want))
            rec["vs"], rec["loss_max_abs_err"] = vs, float(err.max())
            if tol == "bitwise":
                require(rec["n_offloaded"] == 6,
                        f"arm B demoted {rec['demoted']}")
                require(rec["losses"] == want,
                        f"arm B losses {rec['losses']} != A's {want}")
                state = _host_leaves(torch, run.state)
                require(sorted(state) == sorted(finals[vs]) and all(
                    torch.equal(state[p], finals[vs][p]) for p in state),
                    "arm B's final state differs from arm A's")
                rec["bitwise_equal_to_A"] = True
                del state
                # the host's share of the sweep: ranking_metrics, timed
                ranking = metrics_mod.ranking_metrics
                host_s = []

                def timed_ranking(*a, **kw):
                    t = time.perf_counter()
                    out = ranking(*a, **kw)
                    host_s.append(time.perf_counter() - t)
                    return out

                metrics_mod.ranking_metrics = timed_ranking
                try:
                    t0 = time.perf_counter()
                    metrics = run.evaluate()
                    rec["eval_s"] = time.perf_counter() - t0
                finally:
                    metrics_mod.ranking_metrics = ranking
                rec["eval_ranking_metrics_s"] = sum(host_s)
                rec["eval_user_batch"] = run.pipeline.eval_user_batch()
                rec["metrics"] = metrics
                require(rec["eval_user_batch"] == FULL_EVAL_BATCH
                        and all(0.0 <= v <= 1.0 for v in metrics.values()),
                        f"arm B evaluate: {rec['eval_user_batch']}, "
                        f"{metrics}")
                rec["padded_seen"] = {
                    b: padded_seen_ms(torch, dev, run.pipeline.g, test, b)
                    for b in (USER_BATCH, FULL_EVAL_BATCH)}
            elif tol is not None:
                rtol, atol = tol
                require((err <= atol + rtol * np.abs(want)).all(),
                        f"arm {name}: losses {rec['losses']} off {vs}'s "
                        f"{want} (rtol {rtol}, atol {atol})")
                rec["tolerance"] = {"rtol": rtol, "atol": atol}
            if name.startswith("C_"):
                dense = sum(run.state["params"][n.split("'")[1]].numel() * 4
                            for n in rec["int8_store_bytes"])
                store = sum(rec["int8_store_bytes"].values())
                require(len(rec["int8_store_bytes"]) == 2
                        and store < dense / 2,
                        f"arm C int8 store {store} of {dense} fp32 bytes")
                rec["fp32_table_bytes"] = dense
            del run
            _free(torch)
        del finals
        launches = kernels.launch_counts()
    finally:
        engine.BipartiteCSR = sparse.BipartiteCSR
    for name in TIERED_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the tiered_train path")

    def med(xs):
        return float(np.median(xs[TIERED_STEADY:]))

    between = {n: r["allocated_between_steps"][-1] for n, r in arms.items()}
    b = arms["B_demoted_fp32"]
    require(between["A_device"] - between["B_demoted_fp32"]
            >= 0.9 * b["demoted_bytes"],
            f"arm B holds {between['B_demoted_fp32']} bytes between steps "
            f"against A's {between['A_device']}; demoted "
            f"{b['demoted_bytes']}")
    emit({"phase": "tiered_train", "preset": "lightgcn-full",
          "topology": TIERED_TOPOLOGY, "steps": TIERED_STEPS,
          "steady_from_step": TIERED_STEADY,
          "seconds": time.perf_counter() - t_phase,
          "microbatch": FULL_MICROBATCH, "eval_user_batch": FULL_EVAL_BATCH,
          "presets": presets,
          "graph_bytes_reference_count": graph.graph_nbytes(),
          "graph_bytes_held": graph.port_csr_nbytes(),
          "arms": arms,
          "step_ms_median_steady": {n: med(r["ms_per_step"])
                                    for n, r in arms.items()},
          "fetch_commit_ms_median_steady": {
              n: [med(r["fetch_ms"]), med(r["commit_ms"])]
              for n, r in arms.items()},
          "minus_comparator_ms": {
              n: med(r["ms_per_step"]) - med(arms[r["vs"]]["ms_per_step"])
              for n, r in arms.items() if "vs" in r},
          "allocated_between_steps_minus_B": {
              n: v - between["B_demoted_fp32"] for n, v in between.items()},
          "eval_s": {"tiered_train_B": b["eval_s"], "api": api_eval_s},
          "launches": {k: launches[k] for k in TIERED_KERNELS}})
    return launches, graph


# ------------------------------------------------------------------ sharded
def sharded_arm(torch, dev, exp, name, train, test):
    """One arm of ``sharded``: the arm's spec built, its first forward's
    embeddings, the ring's bucket build timed (ring arms), then
    ``Run.fit()`` timed per loop step.  Returns (run, record, embeddings)."""
    run = exp.override({"loop.steps": SHARDED_STEPS, **SHARDED_ARMS[name]}) \
        .build(train=train, holdout=test, device=dev)
    pipe = run.pipeline
    rec = {"arm": name, "describe": run.describe().splitlines()[:3],
           "microbatch": pipe.plan.microbatch}
    if pipe.g.spmm == "ring":
        t0 = time.perf_counter()
        pipe.g._ring.ring("sym")
        torch.cuda.synchronize()
        rec["bucket_build_s"] = time.perf_counter() - t0
        rec["ring_nbytes"] = pipe.g.ring_nbytes()
        rec["port_ring_nbytes"] = pipe.g.port_ring_nbytes()
    emb = pipe.embeddings(run.state)
    timer = StepTimer(torch, pipe.step_context)
    pipe.step_context = timer
    report = run.fit()
    del pipe.step_context
    rec["losses"], rec["ms_per_step"] = report.losses, timer.ms
    require(report.steps_run == SHARDED_STEPS
            and np.isfinite(report.losses).all()
            and pipe.plan.microbatch == FULL_MICROBATCH,
            f"sharded {name}: {report.steps_run} steps, {report.losses}, "
            f"microbatch {pipe.plan.microbatch}")
    return run, rec, emb


def sharded_phase(torch, dev, train, test, graph):
    """Sharded execution at one shard on the card: a one-rank NCCL group
    through a ``FileStore``; the ``lightgcn-full`` preset with
    ``mesh.spmm = "ring"`` (every layer one ``spmm_csr`` over the unified
    402,432 rows, forward and transposed) against the kernel route of the
    same preset (its first forward's embeddings within close_sum's
    tolerance, its losses within the reference's sharded tolerance), and
    the int8 ring payload bit for bit the fp32 ring; ``Run.evaluate()`` on
    the ring run.  Then the ring's and the kernel route's layer, the bare
    ring call forward and transposed, and the one-rank all-reduce, timed.
    Returns the ring runs' launches."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.api import Experiment
    from repro_torch.pipeline import engine, get_model, sparse
    t_phase = time.perf_counter()
    _free(torch)
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(pathlib.Path(tmp) / "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    # the kernel arm reuses tiered_train's graph (its CSR sort is set-up);
    # a ring arm builds its own, ring included
    engine.BipartiteCSR = lambda *a, shard=None, **kw: graph \
        if shard is None else sparse.BipartiteCSR(*a, shard=shard, **kw)
    try:
        exp = Experiment.from_preset("lightgcn-full")
        k_run, k_rec, (k_ue, k_ie) = sharded_arm(torch, dev, exp, "kernel",
                                                 train, test)
        params = {n: t.clone() for n, t in
                  k_run.pipeline.init_state()["params"].items()}
        with torch.no_grad():
            # every term of the LightGCN forward is non-negative over |x|
            a_ue, a_ie = get_model("lightgcn").forward(
                {n: t.abs() for n, t in params.items()}, graph, N_LAYERS)
        del k_run
        _free(torch)
        kernels.reset_launch_counts()
        r_run, r_rec, (r_ue, r_ie) = sharded_arm(torch, dev, exp, "ring",
                                                 train, test)
        q_run, q_rec, (q_ue, q_ie) = sharded_arm(torch, dev, exp,
                                                 "ring_int8", train, test)
        t0 = time.perf_counter()
        metrics = r_run.evaluate()
        eval_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        for name in SHARDED_KERNELS:
            require(launches[name] > 0,
                    f"kernel {name} never launched on the sharded path")
        errs = {"user": close_sum(torch, r_ue, k_ue, a_ue, "ring user emb"),
                "item": close_sum(torch, r_ie, k_ie, a_ie, "ring item emb")}
        want, got = np.array(k_rec["losses"]), np.array(r_rec["losses"])
        loss_err = float(np.abs(got - want).max())
        require((np.abs(got - want) <= SHARDED_ATOL
                 + SHARDED_RTOL * np.abs(want)).all(),
                f"ring losses {got} off the kernel route's {want}")
        require(q_rec["losses"] == r_rec["losses"]
                and torch.equal(q_ue, r_ue) and torch.equal(q_ie, r_ie)
                and all(torch.equal(q_run.state["params"][n],
                                    r_run.state["params"][n])
                        for n in r_run.state["params"]),
                "the int8 ring at one shard differs from the fp32 ring")
        require(all(0.0 <= v <= 1.0 for v in metrics.values()),
                f"sharded evaluate: {metrics}")
        del q_run, q_ue, q_ie, k_ue, k_ie, a_ue, a_ie
        _free(torch)
        # timings, after the launch counts: a layer of each route, the
        # bare ring forward and transposed, the one-rank all-reduce
        g = r_run.pipeline.g
        xu, xi = params["user_embed"], params["item_embed"]
        with torch.no_grad():
            z = torch.cat([xu * g.rsqrt_du[:, None], xi * g.rsqrt_di[:, None]])
            fwd, bwd = g._ring.ring("sym"), g._ring.ring("sym_T")
            times = {
                "ring_layer_ms": cuda_ms(torch,
                                         lambda: g.sym_propagate(xu, xi)),
                "kernel_layer_ms": cuda_ms(
                    torch, lambda: graph.sym_propagate(xu, xi)),
                "ring_spmm_forward_ms": cuda_ms(torch, lambda: fwd(z)),
                "ring_spmm_transposed_ms": cuda_ms(torch, lambda: bwd(z)),
                "all_reduce_ms": cuda_ms(torch, lambda: dist.all_reduce(z)),
            }
        step_med = {r["arm"]: float(np.median(r["ms_per_step"][
            TIERED_STEADY:])) for r in (k_rec, r_rec, q_rec)}
        emit({"phase": "sharded", "preset": "lightgcn-full",
              "group": "nccl, world size 1 (FileStore)",
              "steps": SHARDED_STEPS,
              "seconds": time.perf_counter() - t_phase,
              "arms": [k_rec, r_rec, q_rec],
              "bucket_build_s": r_rec["bucket_build_s"],
              "ring_nbytes": r_rec["ring_nbytes"],
              "port_ring_nbytes": r_rec["port_ring_nbytes"],
              "unified_rows": g._ring.part.n_pad,
              "ring_edges": int(fwd.src[0].numel()),
              "all_reduce_bytes": z.numel() * z.element_size(),
              **times, "step_ms_median_steady": step_med,
              "steady_from_step": TIERED_STEADY,
              "ring_minus_kernel_step_ms": step_med["ring"]
              - step_med["kernel"],
              "embedding_max_abs_err": errs, "loss_max_abs_err": loss_err,
              "tolerance": {"embeddings": f"|err| <= {ATOL} + {RTOL} x sum "
                            "of |terms|", "losses": {"rtol": SHARDED_RTOL,
                                                     "atol": SHARDED_ATOL},
                            "int8_ring": "bitwise"},
              "evaluate_s": eval_s, "metrics": metrics,
              "launches": {k: launches[k] for k in SHARDED_KERNELS}})
        del r_run, z
    finally:
        engine.BipartiteCSR = sparse.BipartiteCSR
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------------------------ phase 7
def check_sddmm(torch, dev, rng) -> float:
    """All four ops, coeff None and given, ~30% of edges masked (the first
    and the last among them), E in {1, 7, 127, 128, 129, 10,000}, D in {1,
    3, 37, 64, 128}, N_x != N_y; integer-valued inputs bitwise, float
    inputs to rtol = atol = 1e-5; the same ops walking edge groups
    (``check_sddmm_groups``); then one 'mul' past 2^31 output elements,
    checked on a sample of edges that holds the last 1,024."""
    from repro_torch.kernels import ops, ref
    worst = check_sddmm_groups(torch, dev, rng)
    for e in (1, 7, 127, 128, 129, 10_000):
        for d in (1, 3, 37, 64, 128):
            n_x, n_y = 3 + e % 97, 50 + e % 31
            mask_np = rng.random(e) < 0.7
            mask_np[0] = mask_np[-1] = False
            idx = [torch.from_numpy(a).to(dev) for a in (
                rng.integers(0, n_x, e).astype(np.int32),
                rng.integers(0, n_y, e).astype(np.int32), mask_np)]
            for integer in (True, False):
                def feats(*shape):
                    a = rng.integers(-3, 4, shape) if integer \
                        else rng.standard_normal(shape)
                    return torch.from_numpy(a.astype(np.float32)).to(dev)
                x, y, coeff = feats(n_x, d), feats(n_y, d), feats(e)
                for op in ("mul", "add", "dot", "copy"):
                    for c in (None, coeff):
                        got = ops.sddmm(op, x, y, *idx, c, impl="cuda")
                        want = ref.sddmm_ref(op, x, y, *idx, c)
                        torch.cuda.synchronize()
                        what = f"sddmm {op} E={e} D={d} coeff={c is not None}"
                        if integer:
                            require(torch.equal(got, want),
                                    f"{what}: not bitwise on integers")
                        else:
                            worst = max(worst, close(torch, got, want, what))
                        require(bool((got[~idx[2]] == 0).all()),
                                f"{what}: a masked edge is not 0")
    # past 2^31 output elements: 64-bit offsets
    e, d, n_x, n_y = 16_778_240, EMBED_DIM, 100_003, 50_021
    require(e * d > 1 << 31, "the large sddmm case is not past 2^31")
    x = torch.randn((n_x, d), device=dev)
    y = torch.randn((n_y, d), device=dev)
    src = torch.randint(0, n_x, (e,), device=dev, dtype=torch.int32)
    dst = torch.randint(0, n_y, (e,), device=dev, dtype=torch.int32)
    mask = torch.rand(e, device=dev) < 0.7
    got = ops.sddmm("mul", x, y, src, dst, mask, impl="cuda")
    torch.cuda.synchronize()
    sample = torch.cat([torch.randint(0, e, (8192,), device=dev),
                        torch.arange(e - 1024, e, device=dev)])
    want = ref.sddmm_ref("mul", x, y, src[sample], dst[sample], mask[sample])
    require(torch.equal(got[sample], want),
            "sddmm past 2^31 elements differs from the plain version")
    del got, x, y, src, dst, mask
    torch.cuda.empty_cache()
    return worst


def check_sddmm_groups(torch, dev, rng) -> float:
    """The kernel walking edge groups: 20,000 edges over 3,000 keys with
    one key holding 12 chunks' worth, ~25 % masked and 500 masked padding
    edges (key 0) at the end; groups keyed on the call's src and on its
    dst ('copy' on src only); D in {1, 37, 128, 130, 516} (rows past one
    32-lane column slab load their tail per edge).  Each call is bitwise
    equal to the same call without groups and held to the plain version
    as ``check_sddmm``'s cases are; then groups of another call (equal
    values, other storage; another mask; 'copy' keyed on dst) raise."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sddmm import CHUNK, group_edges
    worst = 0.0
    n_key, n_other, e_real, e_pad = 3_000, 700, 20_000, 20_500
    key = rng.integers(0, n_key, e_real)
    key[rng.permutation(e_real)[:12 * CHUNK]] = 11
    key = np.concatenate([key, np.zeros(e_pad - e_real, int)])
    mask_np = np.arange(e_pad) < e_real
    mask_np[:e_real] &= rng.random(e_real) > 0.25
    k_t, o_t, mask = (torch.from_numpy(a).to(dev) for a in (
        key.astype(np.int32), rng.integers(0, n_other, e_pad).astype(np.int32),
        mask_np))
    groups = group_edges(k_t, o_t, mask)
    for d in (1, 37, 128, 130, 516):
        for integer in (True, False):
            def feats(*shape):
                a = rng.integers(-3, 4, shape) if integer \
                    else rng.standard_normal(shape)
                return torch.from_numpy(a.astype(np.float32)).to(dev)
            tk, to, coeff = feats(n_key, d), feats(n_other, d), feats(e_pad)
            for op in ("mul", "add", "dot", "copy"):
                keyed = ("src",) if op == "copy" else ("src", "dst")
                for side in keyed:
                    args = (tk, to, k_t, o_t, mask) if side == "src" \
                        else (to, tk, o_t, k_t, mask)
                    got = ops.sddmm(op, *args, coeff, impl="cuda",
                                    groups=groups)
                    plain = ref.sddmm_ref(op, *args, coeff)
                    what = f"sddmm grouped {op} keyed {side} D={d}"
                    require(torch.equal(got, ops.sddmm(op, *args, coeff,
                                                       impl="cuda")),
                            f"{what}: differs from the edge-order walk")
                    if integer or op != "dot":
                        require(torch.equal(got, plain),
                                f"{what}: not bitwise equal to the plain "
                                "version")
                    else:
                        worst = max(worst, close(torch, got, plain, what))
                    require(bool((got[~mask] == 0).all()),
                            f"{what}: a masked edge is not 0")
    x, y = torch.ones((n_key, 4), device=dev), torch.ones((n_other, 4),
                                                           device=dev)
    for bad, args in (
            (group_edges(k_t.clone(), o_t.clone(), mask),
             ("mul", x, y, k_t, o_t, mask)),
            (groups, ("mul", x, y, k_t, o_t, mask.clone())),
            (groups, ("copy", y, x, o_t, k_t, mask))):
        try:
            ops.sddmm(*args, impl="cuda", groups=bad)
        except ValueError:
            continue
        raise SmokeFailure("sddmm took groups of another call")
    return worst


def rel_norm(a, b) -> float:
    """|a - b| / |b| in the Frobenius norm, in float64 (the tables' values
    can pass float32's range when squared)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def timed(torch, fn):
    """(result, host ms) around a synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def all_finite(torch, tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def coo_forwards(torch, g, params, csr_g):
    """``core.ngcf.forward`` at O3, O2, O1, O0 under no_grad (each twice:
    ms of both calls, peak memory), each level against O3 and O3 against
    the CSR registry forward; then LightGCN's COO forward against the
    CSR one.  Returns the phase record and the depth used."""
    from repro_torch import kernels
    from repro_torch.core import lightgcn, ngcf
    from repro_torch.pipeline import get_model
    out = {"ngcf": {}}
    depth = N_LAYERS
    if not all_finite(torch, ngcf.forward(params, g, opt_level=3)):
        depth = TRAIN_LAYERS
        emit({"reduced": {"coo_forward_layers": depth,
                          "config_n_layers": N_LAYERS,
                          "why": "the 3-layer COO NGCF forward is not finite "
                                 "on this graph"}})
    p = dict(params, w1=params["w1"][:depth], w2=params["w2"][:depth])
    ref3 = None
    for level in (3, 2, 1, 0):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()["sddmm"]
        ms = []
        for _ in range(2):
            res, t = timed(torch, lambda: ngcf.forward(
                p, g, opt_level=level, impl=LEVEL_IMPL.get(level)))
            ms.append(t)
        launched = (kernels.launch_counts()["sddmm"] - before) // 2
        rec = {"ms": ms, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "finite": all_finite(torch, res), "sddmm_launches": launched}
        require(launched == {3: depth, 2: 2 * depth}.get(level, 0),
                f"O{level} forward launched sddmm {launched} times")
        require(tuple(res[0].shape) == (N_USERS, (depth + 1) * EMBED_DIM)
                and tuple(res[1].shape) == (N_ITEMS, (depth + 1) * EMBED_DIM),
                f"O{level} forward has the wrong shape")
        require(rec["finite"], f"O{level} forward is not finite")
        if level == 3:
            ref3 = res
            csr = get_model("ngcf").forward(p, csr_g, depth)
            rec["vs_csr_rel_norm"] = [rel_norm(a, b) for a, b in zip(res, csr)]
            require(max(rec["vs_csr_rel_norm"]) <= GRAD_RTOL,
                    f"COO O3 vs CSR forward: {rec['vs_csr_rel_norm']}")
            del csr
        else:
            rec["vs_O3_rel_norm"] = [rel_norm(a, b) for a, b in zip(res, ref3)]
            require(max(rec["vs_O3_rel_norm"]) <= GRAD_RTOL,
                    f"O{level} vs O3 forward: {rec['vs_O3_rel_norm']}")
        out["ngcf"][f"O{level}"] = rec
        del res
    out["ngcf_layers"] = depth
    del ref3
    lp = {"user_embed": params["user_embed"], "item_embed": params["item_embed"]}
    ms = []
    for _ in range(2):
        res, t = timed(torch, lambda: lightgcn.forward(lp, g, n_layers=N_LAYERS))
        ms.append(t)
    csr = get_model("lightgcn").forward(lp, csr_g, N_LAYERS)
    rel = [rel_norm(a, b) for a, b in zip(res, csr)]
    require(all_finite(torch, res) and max(rel) <= GRAD_RTOL,
            f"LightGCN COO vs CSR forward: {rel}")
    out["lightgcn"] = {"layers": N_LAYERS, "ms": ms, "vs_csr_rel_norm": rel}
    return out, depth


def grads_rel(grads, want) -> dict:
    """Per-leaf relative error in the norm, over matching param trees."""
    from repro_torch.optim.optimizers import tree_leaves
    got, ref_ = tree_leaves(grads), tree_leaves(want)
    names = [f"leaf{i}{tuple(t.shape)}" for i, t in enumerate(ref_)]
    return {n: rel_norm(a, b) for n, a, b in zip(names, got, ref_)}


def coo_fig5(torch, dev, g, params, pipe, train):
    """The paper's Fig 5 training arm: BPR loss and gradients over one
    150,528-sample batch through ``ngcf.forward`` at O1, O2 and O3 (2
    layers), each held against the CSR ``Pipeline.grads_for_batch`` on the
    same params and batch; then O0 against O3 on a prefix of the train
    edges, where O0's [E, D] residuals fit."""
    from repro_torch import kernels
    from repro_torch.core import bpr, graph, ngcf
    from repro_torch.core.train_step import bpr_value_and_grad
    from repro_torch.optim.optimizers import tree_leaves
    p = dict(params, w1=params["w1"][:TRAIN_LAYERS],
             w2=params["w2"][:TRAIN_LAYERS])
    rng = np.random.default_rng(SEED)
    batch_np = bpr.sample_bpr_batch(rng, train.user, train.item, N_ITEMS,
                                    TARGET_BATCH)
    batch = [torch.from_numpy(a).to(dev, torch.int64) for a in batch_np]
    loss_c, grads_c = pipe.grads_for_batch(p, *batch_np)
    out = {"layers": TRAIN_LAYERS, "batch": TARGET_BATCH}
    for level in (1, 2, 3):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()["sddmm"]
        (loss, grads), ms = timed(torch, lambda: bpr_value_and_grad(
            lambda q: ngcf.forward(q, g, opt_level=level,
                                   impl=LEVEL_IMPL.get(level)), p, *batch))
        launched = kernels.launch_counts()["sddmm"] - before
        require(launched == {3: 1, 2: 2}.get(level, 0) * TRAIN_LAYERS,
                f"O{level} gradients launched sddmm {launched} times")
        require(all_finite(torch, tree_leaves(grads)),
                f"O{level} gradients are not finite")
        rel = grads_rel(grads, grads_c)
        loss_rel = abs(float(loss) - loss_c) / abs(loss_c)
        require(loss_rel <= RTOL, f"O{level} loss {float(loss)} vs CSR {loss_c}")
        for n, r in rel.items():
            require(r <= GRAD_RTOL, f"O{level} gradient {n} vs CSR: {r}")
        out[f"O{level}"] = {"ms": ms, "loss": float(loss),
                            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                            "loss_rel_err_vs_csr": loss_rel,
                            "grad_rel_norm_vs_csr": rel,
                            "sddmm_launches": launched}
        del grads
    out["csr_loss"] = loss_c
    del grads_c
    # O0 keeps ~5 [E, D] residuals per layer: time it against O3 on a prefix
    n = PREFIX_EDGES
    gp = graph.bipartite_from_numpy(train.user[:n], train.item[:n], N_USERS,
                                    N_ITEMS, device=dev)
    gp.user_groups()                      # set-up, outside the timed calls
    pre = {}
    for level in (0, 3):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(2):
            (loss, grads), t = timed(torch, lambda: bpr_value_and_grad(
                lambda q: ngcf.forward(q, gp, opt_level=level), p, *batch))
            ms.append(t)
        require(all_finite(torch, tree_leaves(grads)),
                f"prefix O{level} gradients are not finite")
        pre[level] = (grads, {"ms": ms, "loss": float(loss),
                              "peak_memory_bytes":
                                  torch.cuda.max_memory_allocated()})
    rel = grads_rel(pre[0][0], pre[3][0])
    for name, r in rel.items():
        require(r <= GRAD_RTOL, f"prefix O0 gradient {name} vs O3: {r}")
    out["prefix"] = {"edges": n, "O0": pre[0][1], "O3": pre[3][1],
                     "O0_vs_O3_grad_rel_norm": rel,
                     "train_speedup_O0_to_O3": pre[0][1]["ms"][1]
                     / pre[3][1]["ms"][1]}
    emit({"reduced": {"fig5_train_layers": TRAIN_LAYERS,
                      "config_n_layers": N_LAYERS,
                      "O0_train_edges": n, "train_edges": train.n_edges,
                      "why": "3 unnormalised NGCF layers overflow float32 in "
                             "the backward; O0's backward keeps ~5 [E, D] "
                             "tensors per layer (38.6 GB at 15.08M edges), so "
                             "O0 and O3 are timed on a prefix of 2^22 edges"}})
    return out


def coo_cells(torch, dev, g, params, train):
    """The NGCF/LightGCN FULL cells' training step (reference
    ``launch/cells.py:739-776``): ``TRAIN_STEPS`` Adam steps each, NGCF at
    O3 with 2 layers, LightGCN with 3, one 150,528-sample BPR batch per
    step; losses finite and every parameter updated."""
    from repro_torch import kernels
    from repro_torch.core import bpr, lightgcn, ngcf
    from repro_torch.core.train_step import full_graph_step
    from repro_torch.optim import adam
    from repro_torch.optim.optimizers import tree_leaves
    rng = np.random.default_rng(SEED + 1)
    out = {}
    runs = {"ngcf": (dict(params, w1=params["w1"][:TRAIN_LAYERS],
                          w2=params["w2"][:TRAIN_LAYERS]), TRAIN_LAYERS,
                     lambda q: ngcf.forward(q, g, opt_level=3)),
            "lightgcn": ({k: params[k] for k in ("user_embed", "item_embed")},
                         N_LAYERS,
                         lambda q: lightgcn.forward(q, g, n_layers=N_LAYERS))}
    for arch, (p, layers, forward) in runs.items():
        opt = adam(CELLS_LR)
        step = full_graph_step(forward, opt)
        first = tree_leaves(p)
        state = opt.init(p)
        before = kernels.launch_counts()["sddmm"]
        steps = []
        for k in range(TRAIN_STEPS):
            batch = [torch.from_numpy(a).to(dev, torch.int64)
                     for a in bpr.sample_bpr_batch(rng, train.user, train.item,
                                                   N_ITEMS, TARGET_BATCH)]
            (p, state, loss), ms = timed(
                torch, lambda: step(p, state, *batch))
            require(np.isfinite(float(loss)), f"{arch} cells step {k}: "
                                              "non-finite loss")
            steps.append({"step": k, "loss": float(loss), "ms": ms})
        launched = kernels.launch_counts()["sddmm"] - before
        want = TRAIN_STEPS * layers if arch == "ngcf" else 0
        require(launched == want, f"{arch} cells launched sddmm {launched} "
                                  f"times, expected {want}")
        last = tree_leaves(p)
        require(all(not torch.equal(a, b) for a, b in zip(first, last))
                and all_finite(torch, last),
                f"{arch} cells: a parameter did not change or is not finite")
        out[arch] = {"layers": layers, "steps": steps,
                     "sddmm_launches": launched}
        del p, state, first, last
    out["optimizer"] = f"adam lr {CELLS_LR}"
    return out


def coo_fig6(torch, g, params):
    """The paper's Fig 6 breakdown of one O3 layer (layer 0): the SDDMM,
    the two SpMMs of its messages, the two copy-sum aggregations, the four
    node-level matmuls and the whole layer, CUDA events each."""
    from repro_torch.core import sparse_ops
    from repro_torch.core.message_passing import ngcf_propagate_bipartite
    from repro_torch.kernels import ops
    xu, xi = params["user_embed"], params["item_embed"]
    w1, w2 = params["w1"][0], params["w2"][0]
    u, i, mask, grp = g.user, g.item, g.edge_mask, g.user_groups()
    mul_e = ops.sddmm("mul", xu, xi, u, i, mask, groups=grp)
    sddmm_ms = cuda_ms(torch, lambda: ops.sddmm("mul", xu, xi, u, i, mask,
                                                groups=grp), reps=5)
    spmm_ms = (cuda_ms(torch, lambda: sparse_ops.spmm(
        "sum", mul_e, i, N_ITEMS, mask), reps=3)
        + cuda_ms(torch, lambda: sparse_ops.spmm(
            "sum", mul_e, u, N_USERS, mask), reps=3))
    del mul_e
    copy_ms = (cuda_ms(torch, lambda: sparse_ops.gspmm_copy_sum(
        xu, u, i, N_ITEMS, mask), reps=3)
        + cuda_ms(torch, lambda: sparse_ops.gspmm_copy_sum(
            xi, i, u, N_USERS, mask), reps=3))
    # two [n_items, D] and two [n_users, D] products by a [D, D] weight
    matmul_ms = 2 * (cuda_ms(torch, lambda: xi @ w1, reps=10)
                     + cuda_ms(torch, lambda: xu @ w2, reps=10))
    layer_ms = cuda_ms(torch, lambda: ngcf_propagate_bipartite(
        g, xu, xi, w1, w2, opt_level=3), reps=3)
    return {"sddmm_ms": sddmm_ms, "spmm_ms": spmm_ms,
            "copy_sum_ms": copy_ms, "matmul_ms": matmul_ms,
            "layer_ms": layer_ms,
            "sparse_fraction": (sddmm_ms + spmm_ms) / layer_ms,
            "sparse_fraction_with_copy_sums":
                (sddmm_ms + spmm_ms + copy_ms) / layer_ms}


def time_sddmm(torch, g, params, errs, launches_per_forward, groups_ms):
    """``sddmm`` at the O3 shape (layer 0's tables, every train edge),
    walking the graph's user groups (built once, before, in
    ``groups_ms``): 'mul' against its plain version (bitwise), the
    edge-order walk (bitwise) and a two-call yardstick; 'dot' at the same
    edges against its plain version and ``torch.sparse.sampled_addmm``
    over the live edges' CSR pattern (built from the groups outside the
    window).  Bounds from this run's inputs: each input read once, the
    output written once."""
    from repro_torch.kernels import ops, ref
    xu, xi = params["user_embed"], params["item_embed"]
    u, i, mask, grp = g.user, g.item, g.edge_mask, g.user_groups()
    args = (xu, xi, u, i, mask)

    def kernel(op, groups=grp):
        return ops.sddmm(op, *args, impl="cuda", groups=groups)

    got = kernel("mul")
    want = ref.sddmm_ref("mul", *args)
    require(torch.equal(got, want), "sddmm main shape: not bitwise equal to "
                                    "the plain version")
    errs["sddmm"] = max(errs["sddmm"], max_err(got, want))
    del want
    require(torch.equal(got, kernel("mul", None)),
            "sddmm main shape: grouped and edge-order walks differ")
    del got
    t_k = cuda_ms(torch, lambda: kernel("mul"), reps=10)
    t_e = cuda_ms(torch, lambda: kernel("mul", None), reps=10)
    t_p = cuda_ms(torch, lambda: ref.sddmm_ref("mul", *args), reps=3)
    t_y = cuda_ms(torch, lambda: xu.index_select(0, u) * xi.index_select(0, i),
                  reps=5)
    e, d = u.numel(), xu.shape[1]
    inputs = (xu.numel() * 4 + xi.numel() * 4 + u.numel() * 4 + i.numel() * 4
              + mask.numel() * mask.element_size())
    b_ms, b_by = bound(inputs + e * d * 4, float(e * d))
    got = kernel("dot")
    want = ref.sddmm_ref("dot", *args)
    errs["sddmm"] = max(errs["sddmm"], close(torch, got, want,
                                             "sddmm dot main"))
    require(torch.equal(got, kernel("dot", None)),
            "sddmm dot main: grouped and edge-order walks differ")
    del want
    t_dk = cuda_ms(torch, lambda: kernel("dot"), reps=10)
    t_de = cuda_ms(torch, lambda: kernel("dot", None), reps=10)
    t_dp = cuda_ms(torch, lambda: ref.sddmm_ref("dot", *args), reps=3)
    db_ms, db_by = bound(inputs + e * 4, 2.0 * e * d)
    # the library yardstick of 'dot': one sampled dense-dense product over
    # the live edges' CSR pattern (rows = users, in the groups' order)
    live = grp.mask_sorted.bool()
    rows = grp.key_sorted[live].long()
    crow = torch.zeros(N_USERS + 1, dtype=torch.int64, device=xu.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=N_USERS), 0)
    cols = grp.other_sorted[live].long()
    with warnings.catch_warnings():         # beta-state notices only
        warnings.simplefilter("ignore", UserWarning)
        pattern = torch.sparse_csr_tensor(
            crow, cols, torch.zeros(cols.numel(), device=xu.device),
            size=(N_USERS, N_ITEMS))
        xi_t = xi.t()
        lib = torch.sparse.sampled_addmm(pattern, xu, xi_t)
        err = close(torch, lib.values(), got[grp.perm[live].long()],
                    "sddmm dot vs sampled_addmm")
        del lib, got
        t_l = cuda_ms(torch, lambda: torch.sparse.sampled_addmm(
            pattern, xu, xi_t), reps=10)
    del pattern, rows, cols, crow, live
    groups_bytes = sum(t.numel() * t.element_size() for t in (
        grp.perm, grp.key_sorted, grp.other_sorted, grp.mask_sorted))
    rec = dict(ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, edge_order_ms=t_e, yardstick_ms=t_y,
               yardstick="x.index_select(0, src) * y.index_select(0, dst)",
               launches_per_forward=launches_per_forward,
               groups_build_ms=groups_ms, groups_bytes=groups_bytes,
               work=f"mul, E={e} D={d} (one O3 layer), walking user groups",
               dot={"ms": t_dk, "edge_order_ms": t_de, "plain_ms": t_dp,
                    "bound_ms": db_ms, "bound_by": db_by,
                    "library_ms": t_l, "library_max_abs_err": err,
                    "library": "torch.sparse.sampled_addmm(csr_pattern, "
                               "x_user, x_item.T)"})
    emit({"kernel": "sddmm", "kernel_ms": t_k,
          **{k: v for k, v in rec.items() if k != "ms"},
          "max_abs_err": errs["sddmm"], "tolerance": TOLERANCE["sddmm"]})
    return rec


def coo_phase(torch, dev, train, pipe, errs):
    """The seed COO path at NGCF FULL width on the smoke's graph; the
    launch counts are read around the forwards, the Fig 5 arm and the
    cells' steps (the Fig 6 and kernel timings come after)."""
    from repro_torch import kernels
    from repro_torch.core import graph, ngcf
    t0 = time.perf_counter()
    g = graph.bipartite_from_numpy(train.user, train.item, N_USERS, N_ITEMS,
                                   device=dev)
    params = ngcf.init_params(SEED, N_USERS, N_ITEMS, EMBED_DIM, N_LAYERS,
                              device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _, groups_ms = timed(torch, g.user_groups)      # once per graph
    kernels.reset_launch_counts()
    with torch.no_grad():
        fwd, depth = coo_forwards(torch, g, params, pipe.g)
    fig5 = coo_fig5(torch, dev, g, params, pipe, train)
    cells = coo_cells(torch, dev, g, params, train)
    launches = kernels.launch_counts()
    require(launches["sddmm"] > 0, "sddmm never launched on the COO path")
    with torch.no_grad():
        fig6 = coo_fig6(torch, g, params)
        rec = time_sddmm(torch, g, params, errs, depth, groups_ms)
    emit({"phase": "coo", "config": "ngcf-3l-128e", "edges": train.n_edges,
          "setup_s": setup_s, "user_groups_build_ms": groups_ms,
          "forward": fwd, "fig5_train": fig5,
          "inference_speedup_O0_to_O3": fwd["ngcf"]["O0"]["ms"][1]
          / fwd["ngcf"]["O3"]["ms"][1],
          "cells_train": cells, "fig6_layer": fig6, "launches": launches})
    return launches, rec, params


def subgraph_phase(torch, dev, train, params):
    """The paper's headline comparison (``examples/fullgraph_vs_subgraph.py``)
    at full width: ``SubgraphTrainer`` over both edge directions (fanout 10,
    2 workers, 256 seeds, loss mean(e²)) beside the COO LightGCN full-graph
    gradient step with a 256-sample BPR batch, at depth 1, 2 and 3."""
    from repro_torch.core import bpr, graph, lightgcn
    from repro_torch.core.train_step import bpr_value_and_grad
    from repro_torch.dist.subgraph import SubgraphTrainer
    g = graph.bipartite_from_numpy(train.user, train.item, N_USERS, N_ITEMS,
                                   device=dev)
    lp = {k: params[k] for k in ("user_embed", "item_embed")}
    x_all = torch.cat([lp["user_embed"], lp["item_embed"]])
    src = np.concatenate([train.user, train.item + N_USERS])
    dst = np.concatenate([train.item + N_USERS, train.user])
    rng = np.random.default_rng(SEED)
    rows = []
    for layers in (1, 2, 3):
        batch = [torch.from_numpy(a).to(dev, torch.int64)
                 for a in bpr.sample_bpr_batch(rng, train.user, train.item,
                                               N_ITEMS, SUB_BATCH)]
        full = [timed(torch, lambda: bpr_value_and_grad(
            lambda q: lightgcn.forward(q, g, n_layers=layers), lp, *batch))[1]
            for _ in range(2)]
        t0 = time.perf_counter()
        tr = SubgraphTrainer(src, dst, N_USERS + N_ITEMS, n_layers=layers,
                             fanout=SUB_FANOUT, n_workers=SUB_WORKERS)
        csr_s = time.perf_counter() - t0
        seeds = rng.integers(0, N_USERS, SUB_BATCH).astype(np.int32)

        def loss(e, s):
            return torch.mean(e ** 2)

        tr.step(seeds, x_all, loss, record=False)             # warm-up
        grads, st = tr.step(seeds, x_all, loss)
        require(all_finite(torch, [grads]), "subgraph gradients not finite")
        t_sub = st.sample_s + st.forward_s + st.backward_s
        rows.append({"layers": layers, "full_graph_ms": full,
                     "subgraph_ms": t_sub * 1e3,
                     "sample_ms": st.sample_s * 1e3,
                     "forward_ms": st.forward_s * 1e3,
                     "backward_ms": st.backward_s * 1e3,
                     "build_pct": st.sample_s / t_sub * 100,
                     "expanded_vertices": st.expanded_vertices,
                     "redundancy": tr.redundancy(), "csr_build_s": csr_s})
        del tr
    emit({"phase": "subgraph", "directed_edges": int(len(src)),
          "nodes": N_USERS + N_ITEMS, "fanout": SUB_FANOUT,
          "workers": SUB_WORKERS, "seeds": SUB_BATCH,
          "full_graph_bpr_batch": SUB_BATCH, "loss": "mean(e^2)",
          "depths": rows})


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
                "hadamard_spmm": check_hadamard(torch, dev, rng),
                "ann_block_scores": check_ann(torch, dev, rng)}
        emit({"phase": "adversarial", "max_abs_err": errs})
        g, train, test = build_graph(torch, dev)
        from repro_torch.pipeline import get_model
        params = get_model("lightgcn").init(SEED, N_USERS, N_ITEMS, EMBED_DIM,
                                            N_LAYERS, device=dev)
        user_f, item_f, serve_launches, eval_users, exact, users = \
            main_path(torch, g, test, params)
        ann_launches, index = ann_serving(torch, g, user_f, item_f, users,
                                          exact)
        times = time_kernels(torch, g, params, user_f, item_f, eval_users,
                             errs)
        large_k_routes(torch, g, test, user_f, item_f, index, eval_users)
        times["ann_block_scores"] = time_ann(torch, index, user_f, users,
                                             errs)
    del g, params, user_f, item_f, index
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
    del layer0
    torch.cuda.empty_cache()
    api_launches, api_eval_s = api_phase(torch, dev, train, test)
    torch.cuda.empty_cache()
    tiered_launches, graph = tiered_train(torch, dev, train, test,
                                          api_eval_s)
    sharded_launches = sharded_phase(torch, dev, train, test, graph)
    del graph
    _free(torch)
    with torch.no_grad():
        errs["sddmm"] = check_sddmm(torch, dev, rng)
    emit({"phase": "adversarial", "kernel": "sddmm",
          "max_abs_err": errs["sddmm"]})
    coo_launches, times["sddmm"], coo_params = coo_phase(torch, dev, train,
                                                         pipe, errs)
    del pipe
    torch.cuda.empty_cache()
    subgraph_phase(torch, dev, train, coo_params)
    paths = {"serving": {k: serve_launches[k] for k in SERVING_KERNELS},
             "ann_serving": {k: ann_launches[k] for k in ANN_KERNELS},
             "training": {k: train_launches[k] for k in TRAINING_KERNELS},
             "coo": {k: coo_launches[k] for k in COO_KERNELS},
             "api": {k: api_launches[k] for k in API_KERNELS},
             "tiered_train": {k: tiered_launches[k]
                              for k in TIERED_KERNELS},
             "sharded": {k: sharded_launches[k] for k in SHARDED_KERNELS}}
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
                     "library_ms": t["library_ms"],
                     **{k: t[k] for k in ("device_ms", "library_device_ms",
                                          "host_us_per_call",
                                          "launch_floor_device_ms",
                                          "launch_floor_host_us", "dot")
                        if k in t}})
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

#!/usr/bin/env python3
"""A/B of the port's row-split ``spmm_csr`` and shape-tiled
``ann_block_scores`` against the versions of a parent checkout (one warp
per destination row; 64 x 64 output tiles), on one card, in one process.

    python3 tools/torch_kernel_ab.py --parent DIR

DIR holds an unpacked parent commit (``git archive``) whose kernels take
the C interfaces of the one-warp-per-row ``spmm_csr`` and the 64 x 64
tile ``ann_block_scores``.  Both versions are built with the
same nvcc flags and run on the same inputs, in the order parent, change,
change, parent:
  * ``spmm_csr`` (sum, gather) over a synthetic graph with the smoke's
    counts (53,248 destination rows, 349,184 source rows of D = 128,
    15,084,083 edges), destination degrees Zipf(0.75) by rank (the
    longest row ~1.7 % of E, as in the smoke's item rows), sources
    uniform: ms per call, CUDA events around 3 calls;
  * ``ann_block_scores`` at B = 64 and B = 16,384 against 832 int8
    centroids of D = 128: device ms per call (100 calls in a CUDA graph,
    ``chip_smoke.device_ms``), and bitwise agreement on integer users.
Prints one JSON line per measurement and a summary line last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N_DST, N_SRC, EDGES, D, ZIPF = 53_248, 349_184, 15_084_083, 128, 0.75
ANN_NB, ANN_SHAPES = 832, (64, 16_384)
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: pathlib.Path) -> dict:
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for name in ("spmm_csr", "ann_block_scores"):
        src = parent / "src/repro_torch/kernels/csrc" / f"{name}.cu"
        so = out_dir / f"parent_{name}.so"
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)])))
    for name, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu")
        libs[name] = ctypes.CDLL(str(so))
    libs["spmm_csr"].spmm_csr_f32.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    libs["ann_block_scores"].ann_block_scores_f32.argtypes = \
        [_P] * 5 + [_I] * 4 + [_P]
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
    _build.build_all(("spmm_csr", "ann_block_scores"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    rows = {}

    # spmm_csr
    w = np.arange(1, N_DST + 1, dtype=np.float64) ** -ZIPF
    deg = np.floor(EDGES * w / w.sum()).astype(np.int64)
    deg[: EDGES - int(deg.sum())] += 1
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])).to(dev)
    src = torch.from_numpy(rng.integers(0, N_SRC, EDGES).astype(np.int32)
                           ).to(dev)
    x = torch.from_numpy(rng.standard_normal((N_SRC, D)).astype(np.float32)
                         ).to(dev)

    def spmm_parent():
        out = torch.empty((N_DST, D), device=dev)
        err = libs["spmm_csr"].spmm_csr_f32(
            x.data_ptr(), indptr.data_ptr(), src.data_ptr(), out.data_ptr(),
            N_DST, D, 1, 0, 1, 0, stream)
        if err:
            raise RuntimeError(f"parent spmm_csr: CUDA error {err}")
        return out

    def spmm_change():
        return ops.spmm_csr("sum", x, indptr, src, N_DST, gather=True,
                            impl="cuda")

    want = ref.spmm_csr_ref("sum", x, indptr, src, N_DST, gather=True)
    abs_sum = ref.spmm_csr_ref("sum", x.abs(), indptr, src, N_DST,
                               gather=True)
    for fn, what in ((spmm_parent, "parent"), (spmm_change, "change")):
        if not bool(((fn() - want).abs() <= 1e-5 + 1e-5 * abs_sum).all()):
            raise RuntimeError(f"spmm_csr {what} disagrees with the plain "
                               "version")
    del want, abs_sum
    times = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        fn = spmm_parent if who == "parent" else spmm_change
        times[who].append(events_ms(torch, fn, reps=3))
    rows["spmm_csr"] = {"work": f"u2i-like: {N_DST} rows, {EDGES} edges, "
                                f"D={D}, longest row {int(deg.max())}",
                        "parent_ms": times["parent"],
                        "change_ms": times["change"]}
    print(json.dumps({"kernel": "spmm_csr", **rows["spmm_csr"]}), flush=True)
    del x, src, indptr

    # ann_block_scores
    cq = torch.from_numpy(rng.integers(-127, 128, (ANN_NB, D))
                          .astype(np.int8)).to(dev)
    scale = torch.from_numpy((rng.random(ANN_NB) / 50).astype(np.float32)
                             ).to(dev)
    zero = torch.zeros(ANN_NB, device=dev)
    for b in ANN_SHAPES:
        ue = torch.from_numpy(rng.integers(-3, 4, (b, D)).astype(np.float32)
                              ).to(dev)

        def ann_parent(ue=ue, b=b):
            out = torch.empty((b, ANN_NB), device=dev)
            err = libs["ann_block_scores"].ann_block_scores_f32(
                ue.data_ptr(), cq.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), out.data_ptr(), b, ANN_NB, D, 0,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"parent ann_block_scores: error {err}")
            return out

        def ann_change(ue=ue):
            return ops.ann_block_scores(ue, cq, scale, zero, impl="cuda")

        want = ref.ann_block_scores_ref(ue, cq, scale, zero)
        for fn, what in ((ann_parent, "parent"), (ann_change, "change")):
            if not torch.equal(fn(), want):
                raise RuntimeError(f"ann_block_scores {what} not bitwise")
        times = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            fn = ann_parent if who == "parent" else ann_change
            times[who].append(chip_smoke.device_ms(torch, fn))
        rows[f"ann_block_scores B={b}"] = {
            "work": f"B={b} nb={ANN_NB} D={D}", "device": "device_ms",
            "parent_ms": times["parent"], "change_ms": times["change"]}
        print(json.dumps({"kernel": "ann_block_scores",
                          **rows[f"ann_block_scores B={b}"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ab": {k: {"parent_ms": min(v["parent_ms"]),
                                 "change_ms": min(v["change_ms"])}
                             for k, v in rows.items()}, "card": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

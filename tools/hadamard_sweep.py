#!/usr/bin/env python3
"""Sweep of the row-split ``hadamard_spmm`` kernel's tuning knobs on one
card: merge items per chunk (an argument), the edge-loop unroll and the
minimum resident blocks per SM (``__launch_bounds__``), the last two set
at build time through the source's ``REPRO_HADAMARD_*`` macros.

    python3 tools/hadamard_sweep.py [--out chiprun_out/hadamard_sweep.jsonl]

Inputs: ``synthetic_graph`` below (the smoke's counts: 349,184
users, 53,248 items, 15,084,083 edges, D = 128, Zipf(0.75) item degrees)
with standard-normal tables.  Per configuration it times, with CUDA
events around 5 calls each, the three call shapes of one NGCF layer's
training: the item direction with y riding the destination
(``hadamard_agg_item`` and its ``d_y``), the user direction likewise
(``hadamard_agg_user``), and the user direction with x_idx = y_idx (the
``d_x`` call, the general path); ``layer_ms`` = 2 x item + user + d_x.
Every build is first held to the plain version (|err| <= 1e-5 + 1e-5 x
the sum of |terms|) at one chunk size.  One JSON line per configuration,
the best last.
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
sys.path.insert(0, str(ROOT / "tools"))

from torch_kernel_ab import D, EDGES, N_ITEMS, N_USERS, \
    events_ms  # noqa: E402

ZIPF = 0.75
CHUNKS = (256, 512, 1024, 2048, 4096)
# (unroll, min blocks per SM)
BUILDS = [(u, b) for u in (2, 4, 8) for b in (2, 3, 4, 6)]


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


def build(variants) -> dict:
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "hadamard_spmm.cu"
    procs = []
    for u, b in variants:
        so = out_dir / f"hadamard_u{u}_b{b}.so"
        flags = [f"-DREPRO_HADAMARD_UNROLL={u}",
                 f"-DREPRO_HADAMARD_MIN_BLOCKS={b}", "-Xptxas", "-v"]
        procs.append(((u, b), so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for key, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.hadamard_spmm_f32.argtypes = list(
            _build.SIGNATURES["hadamard_spmm"]["hadamard_spmm_f32"])
        libs[key] = (lib, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chiprun_out" / "hadamard_sweep.jsonl")
    out_path = ap.parse_args().out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref, row_split
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(BUILDS)
    rng = np.random.default_rng(0)
    g = synthetic_graph(torch, dev)
    xu = torch.from_numpy(rng.standard_normal((N_USERS, D))
                          .astype(np.float32)).to(dev)
    xi = torch.from_numpy(rng.standard_normal((N_ITEMS, D))
                          .astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((N_ITEMS, D))
                          .astype(np.float32)).to(dev)
    calls = {"item": (xu, xi, g["ui_indptr"], g["ui_src"], g["ui_dst"],
                      N_ITEMS),
             "user": (xi, xu, g["iu_indptr"], g["iu_src"], g["iu_dst"],
                      N_USERS),
             "d_x": (ct, xi, g["iu_indptr"], g["iu_src"], g["iu_src"],
                     N_USERS)}
    tables = {(name, c): row_split.chunk_rows(a[2], a[5], a[3].numel(), c)
              for name, a in calls.items() for c in CHUNKS}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib, name, chunk):
        x, y, ip, xi_, yi_, n = calls[name]
        rows = tables[(name, chunk)]
        n_chunks = rows.numel() - 1
        part = torch.empty((n_chunks, 2, D), device=dev)
        out = torch.empty((n, D), device=dev)
        err = lib.hadamard_spmm_f32(
            x.data_ptr(), y.data_ptr(), ip.data_ptr(), xi_.data_ptr(),
            yi_.data_ptr(), rows.data_ptr(), part.data_ptr(), None, 0, 0.0,
            out.data_ptr(), n, n_chunks, chunk, D, 1, 0, stream)
        if err:
            raise RuntimeError(f"hadamard_spmm: CUDA error {err}")
        return out

    for name, args in calls.items():           # every build against plain
        x, y, ip, xi_, yi_, n = args
        want = ref.hadamard_spmm_ref(*args)
        abs_sum = ref.hadamard_spmm_ref(x.abs(), y.abs(), ip, xi_, yi_, n)
        for key, (lib, _) in libs.items():
            got = run(lib, name, 1024)
            if not bool(((got - want).abs() <= 1e-5 + 1e-5 * abs_sum).all()):
                raise RuntimeError(f"build {key} disagrees on {name}")
        del want, abs_sum
    results = []
    with open(out_path, "w") as fh:
        for key, (lib, ptxas) in libs.items():
            for chunk in CHUNKS:
                ms = {name: events_ms(torch, lambda name=name: run(
                    lib, name, chunk), reps=5) for name in calls}
                rec = {"unroll": key[0], "min_blocks": key[1],
                       "chunk": chunk, **ms,
                       "layer_ms": 2 * ms["item"] + ms["user"] + ms["d_x"],
                       "ptxas": ptxas, "card": smi}
                results.append(rec)
                line = json.dumps({k: v for k, v in rec.items()
                                   if k != "ptxas"})
                print(line, flush=True)
                fh.write(json.dumps(rec) + "\n")
    best = min(results, key=lambda r: r["layer_ms"])
    print(json.dumps({"best": {k: best[k] for k in (
        "unroll", "min_blocks", "chunk", "item", "user", "d_x",
        "layer_ms")}, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

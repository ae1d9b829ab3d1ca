#!/usr/bin/env python3
"""Profile gemma2-2b FULL train steps on the card with ``torch.profiler``.

    python3 tools/lm_profile.py [--steps 3] [--rows 25]

Builds gemma2-2b at FULL width (26 layers, bf16 weights from the port's
``init_params``, seed 0), runs one untimed microbatch's loss and
gradients (the process's first backward pays one-time costs), then
``--steps`` Adam 1e-3 ``train_step``s of 4 x 4,096 tokens in 4
microbatches, as ``chip_smoke.py``'s lm phase does: step 1 runs in bf16,
later steps in float32 (C2).  Each step is profiled alone; it prints the
step's wall ms, the summed device time of its kernels and their ratio
(the device's busy share: kernels and copies on one stream do not
overlap), the
count of host-device synchronisations and the top ops by device time.
Also prints a bf16 and a float32 GEMM rate at one of the step's shapes,
and the card's name and power limit.  Needs one card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def gemm_rate(torch, dtype) -> float:
    """TFLOP/s of a [4096, 2304] @ [2304, 9216] matmul (gemma2's FFN up
    projection on one 4,096-token microbatch), 20 calls between events."""
    a = torch.randn(4096, 2304, device="cuda", dtype=dtype)
    b = torch.randn(2304, 9216, device="cuda", dtype=dtype)
    for _ in range(3):
        a @ b
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        a @ b
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / 20
    return 2 * 4096 * 2304 * 9216 / ms / 1e9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch = cs.setup()
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.core.train_step import value_and_grad
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adam
    print(f"gemm TFLOP/s bf16 {gemm_rate(torch, torch.bfloat16):.1f} "
          f"float32 {gemm_rate(torch, torch.float32):.1f}", flush=True)
    cfg = configs.get("gemma2_2b").FULL
    with cs.expandable_segments(torch):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        params = tt.init_params(cfg, cs.SEED, device="cuda")
        toks = torch.randint(0, cfg.vocab, (4, 4096), generator=gen,
                             device="cuda")
        value_and_grad(lambda p: tt.lm_loss(cfg, p, toks[:1], toks[:1]),
                       params)
        opt = adam(1e-3)
        state = opt.init(params)
        for step in range(args.steps):
            dtype = str(params["embed"].dtype).split(".")[-1]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, state, loss = tt.train_step(
                    cfg, opt, params, state, toks, toks, n_microbatches=4)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            device_ms = sum(
                e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            events = prof.key_averages()
            syncs = sum(e.count for e in events
                        if e.key in ("cudaStreamSynchronize",
                                     "cudaDeviceSynchronize"))
            print(f"step {step + 1} ({dtype}): wall {wall:.1f} ms (profiled),"
                  f" device {device_ms:.1f} ms, busy share "
                  f"{device_ms / wall:.3f}, syncs {syncs}, loss "
                  f"{float(loss):.4f}", flush=True)
            print(events.table(sort_by="cuda_time_total",
                               row_limit=args.rows,
                               max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

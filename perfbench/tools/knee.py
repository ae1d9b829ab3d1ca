"""Find the serving knee: the highest offered rate whose backlog does
not grow over a window.

    python3 perfbench/tools/knee.py --workload <serving cell> \
        --rates 2000,4000,8000 [--seconds 10] [--seed 1]

Sets the cell up once (as a run does), then serves each rate's open loop
for ``--seconds`` on a fresh service over the same ``Recommender``, and
prints one JSON line per rate: requests, refused, p50/p99 latency from
when each request was due, how late the generator submitted (p99), the
queue's mean occupancy, and ``drain_s``, the time from the last arrival
to the last answer.  Below the knee ``drain_s`` stays near one batch
and the lateness stays flat; above it both grow with the window.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.serving import RecommenderService
    from repro_torch.serving.queue import WallClock
    from perfbench.harness import bench, program, serve
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = bench.resolve(args.workload)
    mix = dict(cell.mix)
    inputs = program.make_inputs(cell.config, args.seed, "cuda")
    r = program.build_run(cell.config, mix, args.seed, inputs, "cuda")
    svc0 = r.service(clock=WallClock())
    deg = np.bincount(inputs.train_user, minlength=inputs.n_users)
    popular = np.lexsort((np.arange(inputs.n_users), -deg))
    due, users = serve.arrivals(mix, mix["warm_seconds"], popular, args.seed,
                                1)
    serve.open_loop(svc0, due, users, mix["drain_seconds"])
    for i, rate in enumerate(float(x) for x in args.rates.split(",")):
        mix["rate_per_s"] = rate
        due, users = serve.arrivals(mix, args.seconds, popular, args.seed,
                                    10 + i)
        svc = RecommenderService(svc0.rec,
                                 max_batch=r.spec.serve.queue_max_batch,
                                 max_wait_us=r.spec.serve.queue_max_wait_us,
                                 clock=WallClock())
        gc.collect()
        got = serve.open_loop(svc, due, users, mix["drain_seconds"])
        lat = got.lat[got.answered]
        st = svc.stats()
        print(json.dumps({
            "rate_per_s": rate, "requests": len(due),
            "refused": int(got.refused.sum()),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "late_p99_ms": float(np.percentile(got.late, 99) * 1e3),
            "late_max_ms": float(got.late.max() * 1e3),
            "occupancy": st["mean_occupancy"],
            "service_p50_ms": st["service_p50_us"] / 1e3,
            "service_p99_ms": st["service_p99_us"] / 1e3,
            "drain_s": got.last - float(due[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

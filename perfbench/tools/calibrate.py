"""Readings that set the limits of ``correct``, at a cell's own size.

    python3 perfbench/tools/calibrate.py --workload <name> \
        [--program-seeds a,b,...] [--control-seeds x,y,z] \
        [--fault-seeds p,q,r] [--seconds S] [--out FILE]

One JSON line per reading, on standard output and appended to ``--out``:
``{"workload", "seed", "kind", "numbers", "seconds"}``.

- program: a training cell's set-up as a run makes it (the graph, the
  ``Run``, its first steps through ``Run.fit``), one epoch of steps as
  the window takes them, the end steps, then the float32 reference; the
  numbers of a sound run (the lower end of each limit).  Serving cells
  take these from whole runs of ``run.py``.
- control: the reference one precision below the configuration's in
  the program's place (``harness/control.py``), for the end steps from a
  sound program's state: the upper end.  A training cell's control seed
  gives that program's readings too.
- fault (training): the program with half of each batch left out and the
  mean taken over the rest (``Pipeline._next_target_batch`` cut in this
  process only), in every step, so in the first and in the end steps.

Needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


@contextlib.contextmanager
def half_batch():
    """Every step of the program takes the first half of its rows."""
    from repro_torch.pipeline.engine import Pipeline
    orig = Pipeline._next_target_batch

    def cut(self, k, step):
        users, pos, neg = orig(self, k, step)
        h = len(users) // 2
        return users[:h], pos[:h], neg[:h]

    Pipeline._next_target_batch = cut
    try:
        yield
    finally:
        Pipeline._next_target_batch = orig


def program_run(cell, seed, device):
    """(inputs, first-step readings, rows a step, end steps) of the
    program, driven as a run drives it, the window cut to one epoch."""
    from perfbench.harness import program, train
    cfg, mix = cell.config, cell.mix
    inputs = program.make_inputs(cfg, seed, device)
    r = program.build_run(cfg, mix, seed, inputs, device)
    plan = r.pipeline.plan
    rows = plan.microbatches_for_epoch(0) * plan.global_microbatch
    readings = train.first_steps(r, int(mix["follow_steps"]))
    r.fit(steps=int(mix["warm_steps"]) + r.steps_for_epochs(1))
    end = train.end_steps(r, int(mix["end_steps"]))
    del r
    program.free(device)
    return inputs, readings, rows, end


def program_numbers(cell, seed, device, run=None):
    """The numbers of a sound run (of ``run``, a ``program_run``, where
    given)."""
    from perfbench.harness import check, train
    cfg, mix = cell.config, cell.mix
    inputs, readings, rows, end = run or program_run(cell, seed, device)
    ref = train.reference_follow(cfg, mix, inputs, seed, device)
    ref_end = train.reference_follow(cfg, mix, inputs, seed, device, end=end)
    numbers = check.train_numbers(*readings, ref,
                                  abs(rows - cfg["bpr_batch"]))
    numbers.update(check.end_numbers(end.losses, end.change, ref_end))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench.harness import bench
    from perfbench.run import host_threads
    cell = bench.resolve(args.workload)
    host_threads(cell.mix)          # as a run of the cell has it
    import numpy as np
    import torch
    from perfbench.harness import control, program, serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = args.seconds or bench.load_json(
        ROOT / "BENCHMARK.json")["run_seconds"]
    device = "cuda"

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def emit(seed, kind, numbers, t0):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "kind": kind, "numbers": numbers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in seeds(args.program_seeds):
        t0 = time.perf_counter()
        emit(seed, "program", program_numbers(cell, seed, device), t0)
        program.free(device)
    for seed in seeds(args.fault_seeds):
        t0 = time.perf_counter()
        with half_batch():
            numbers = program_numbers(cell, seed, device)
        emit(seed, "fault_half_batch", numbers, t0)
        program.free(device)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        if cell.kind == "train":
            run = program_run(cell, seed, device)
            emit(seed, "program", program_numbers(cell, seed, device, run),
                 t0)
            numbers = control.train_numbers(cell, run[0], seed, device,
                                            run[3])
        else:
            inputs = program.make_inputs(cell.config, seed, device)
            deg = np.bincount(inputs.train_user, minlength=inputs.n_users)
            popular = np.lexsort((np.arange(inputs.n_users), -deg))
            _, users = serve.arrivals(cell.mix, seconds, popular, seed, 2)
            numbers = control.serve_numbers(cell, inputs, seed, device,
                                            users.astype(np.int64),
                                            int(cell.mix["k"]))
        emit(seed, "control", numbers, t0)
        program.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

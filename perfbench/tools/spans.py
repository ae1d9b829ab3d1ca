"""One run of a cell with the program's own spans on: the traced phase's
device idle time by span, and what the spans cost.

    python3 perfbench/tools/spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The run is ``perfbench/run.py``'s (same runner, same result line), with
``repro_torch.trace`` enabled before set-up, so set-up's spans
count.  With ``--trace 0`` its end-to-end metrics are those of a run
with the spans on: against a ``run.py`` run, the spans' cost.  With
``--trace 1`` the traced phase is read through ``harness/spans.events``
(device-side user annotations dropped, so busy time holds), and the line
gains ``spans``: per span name in the traced window its ranges, summed
host seconds, union and the device's idle seconds inside the union,
beside the window and busy seconds; ``per_unit``: the figures a step
(training; steps counted by ``step::fetch``) or a batch (serving,
``serve::batch``) the per-layer metrics of the spans would read; and
``program``: the process's span totals and host waits at its end.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

WAIT = "repro::host_wait::"


def per_unit(rep, kind: str) -> dict:
    """The spans' figures per step (``kind`` 'train') or per batch
    ('serve') of the traced window."""
    unit = "repro::step::fetch" if kind == "train" else "repro::serve::batch"
    n = rep.count.get(unit, 0)
    if n == 0:
        return {}
    waits = sum(c for name, c in rep.count.items() if name.startswith(WAIT))
    out = {"units": n, "host_waits": waits / n}
    if kind == "train":
        name = "repro::step::batch"
        out["step_batch_ms"] = 1e3 * rep.host_s.get(name, 0.0) / n
        out["idle_in_batch_share"] = \
            100.0 * rep.span_idle_s.get(name, 0.0) / rep.window_s
    else:
        name = "repro::serve::batch"
        out["seen_stage_ms"] = \
            1e3 * rep.host_s.get("repro::serve::seen", 0.0) / n
        out["idle_in_batch_share"] = \
            100.0 * rep.span_idle_s.get(name, 0.0) / rep.span_s[name]
    return out


def traced_run(workload: str, seed: int, seconds: float, trace: bool,
               device="cuda", cell=None) -> dict:
    """``run.run_cell`` with the program's spans on; with ``trace`` the
    result gains ``spans`` and ``per_unit``, and always ``program``."""
    from perfbench import run
    from perfbench.harness import bench, spans
    from perfbench.harness import trace as tracing
    from repro_torch import trace as program_trace
    cell = cell if cell is not None else bench.resolve(workload)
    seen = {}

    def read(prof):
        evs = spans.events(prof)
        seen["report"] = spans.report(evs)
        return evs

    orig = tracing.from_profiler
    tracing.from_profiler = read
    program_trace.enable(True)
    try:
        result = run.run_cell(workload, seed, seconds, trace, device, cell)
    finally:
        program_trace.enable(False)
        tracing.from_profiler = orig
    rep = seen.get("report")
    if rep is not None:
        result["spans"] = dataclasses.asdict(rep)
        result["per_unit"] = per_unit(rep, cell.kind)
    result["program"] = program_trace.snapshot()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from perfbench import run
    run._paths()
    from perfbench.harness import bench
    cell = bench.resolve(args.workload)
    run.host_threads(cell.mix)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    result = traced_run(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", cell)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints progress on standard error and, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
a ``breakdown``, then ``build`` (the program's kernels this run built
with ``nvcc``, and the seconds it spent building and loading them: a
checkout's first run builds, and its ``setup_s`` holds that), and last
``checks``: each number that decided ``correct`` beside its limit (also
the last lines of standard error).
Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program's sources beside it, or
when JAX or the JAX package was loaded in the process.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the host's thread pools, sized by a mix's ``host_threads``
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def _paths() -> None:
    """The checkout's ``src`` (the program) and root (``perfbench``) on
    the import path; every build and kernel cache inside the checkout."""
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def host_threads(mix: dict) -> None:
    """The mix's ``host_threads`` for torch's and the libraries' pools,
    set before they are imported; their defaults (a thread per core)
    where it names none."""
    n = mix.get("host_threads")
    if n is None:
        return
    for var in THREAD_VARS:
        os.environ[var] = str(int(n))
    import torch
    torch.set_num_threads(int(n))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def kernel_builds():
    """What the program's kernel builder does meanwhile: the kernels it
    built (none where the checkout has them all) and its seconds."""
    from repro_torch.kernels import _build
    missing = [n for n in _build.SIGNATURES
               if not _build.library_path(n).exists()]
    orig = _build.build_all
    out = {"kernels_built": [], "build_s": 0.0}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            out["build_s"] += time.perf_counter() - t0

    _build.build_all = timed
    try:
        yield out
    finally:
        _build.build_all = orig
        out["kernels_built"] = [n for n in missing
                                if _build.library_path(n).exists()]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", cell=None, t0: float = T0) -> dict:
    """One run of a cell; the result object (without ``device.kind``)."""
    import torch
    from perfbench.harness import bench
    from perfbench.harness.outcome import per_layer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cell if cell is not None else bench.resolve(workload)
    runner = __import__(f"perfbench.harness.{cell.kind}",
                        fromlist=["run"])
    with kernel_builds() as build:
        out = runner.run(cell, seed, seconds, trace, device, t0)
    if trace:
        metrics = per_layer(cell, out.context)
    else:
        metrics = {m["name"]: {"value": float(out.end_to_end[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu", "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": bool(out.correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": dev}
    summary = out.context.trace if out.context is not None else None
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["build"] = build
    result["info"] = out.info
    result["checks"] = out.checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program beside the benchmark: {ROOT / 'src' / 'repro_torch'}"
              " is missing", file=sys.stderr)
        return 4
    _paths()
    from perfbench.harness import bench
    cell = bench.resolve(args.workload)
    host_threads(cell.mix)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); "
              f"available={torch.cuda.is_available()}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", cell)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 5
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    info = result.pop("info")
    print(f"card: {smi}", file=sys.stderr)
    print("build: " + json.dumps(result["build"]), file=sys.stderr)
    print("info: " + json.dumps(info), file=sys.stderr)
    checks = {n: {k: (v if math.isfinite(v) else repr(v))
                  for k, v in c.items()}
              for n, c in result.pop("checks").items()}
    result["checks"] = checks          # the last key of the line
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

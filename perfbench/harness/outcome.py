"""One run's result, as the runners hand it to ``run.py``."""
from __future__ import annotations

import dataclasses
import sys

from perfbench.harness import bench
from perfbench.harness.context import Context


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: dict                 # name -> value, host clock
    context: Context | None          # what the per-layer readers read
    memory_peak_bytes: int
    checks: dict                     # name -> {"value", "limit"}
    info: dict = dataclasses.field(default_factory=dict)


def log(**kw) -> None:
    """One line of the run's progress on standard error."""
    print(" ".join(f"{k}={v}" for k, v in kw.items()), file=sys.stderr,
          flush=True)


def per_layer(cell, ctx: Context) -> dict:
    """Every per-layer metric of the cell its reader finds a value for."""
    out = {}
    for m in cell.per_layer:
        value = bench.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

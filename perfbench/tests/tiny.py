"""A cell of ``BENCHMARK.json`` cut to a size a CPU test holds: the same
files, runners, reference and limits, on a small graph."""
from __future__ import annotations

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench.harness import bench  # noqa: E402

SIZES = {"n_users": 300, "n_items": 200, "n_edges": 6000, "embed_dim": 16,
         "bpr_batch": 512}


def tiny(workload: str):
    """The cell with the configuration's sizes cut to ``SIZES`` and the
    schedule's batch to match (the limits and everything else kept)."""
    cell = copy.deepcopy(bench.resolve(workload))
    cfg = cell.config
    cfg.update(SIZES)
    b = SIZES["bpr_batch"]
    cfg["overrides"] = {**cfg["overrides"], "model.embed_dim": 16,
                        "plan.target_batch": b, "plan.microbatch": b}
    if "overrides" in cell.mix:
        ov = dict(cell.mix["overrides"])
        if "plan.base_batch" in ov:
            ov["plan.base_batch"] = b
        cell.mix["overrides"] = ov
    if cell.kind == "serve":
        cell.mix.update(rate_per_s=400.0, warm_seconds=0.2, trace_seconds=0.2)
    else:
        cell.mix.update(trace_seconds=0.2)
    return cell

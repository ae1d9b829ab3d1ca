"""Resolve a cell of ``BENCHMARK.json`` to its data files, by name.

A cell names a configuration and a traffic mix; each lives in a file of
its own (``configs/<name>.json``, ``mixes/<name>.json``), the limits of
the numbers that decide ``correct`` in ``limits/<config>.<kind>.json``
(``kind`` is the mix's: ``train`` or ``serve``), and each per-layer
metric's reader in ``metrics/<name>.py``.  Adding a cell, a mix or a
metric is adding files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

PERFBENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]     # the cell's end-to-end metric entries
    per_layer: list[dict]      # the cell's per-layer metric entries
    chips: int

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:                     # per-layer, no list
        return metric["moves"] in e2e_names
    return True                               # end-to-end, no list


def resolve(workload: str, bench: dict | None = None,
            root: pathlib.Path = PERFBENCH) -> Cell:
    """The cell ``workload`` with its configuration, mix, limits and
    metrics read from their files."""
    if bench is None:
        bench = load_json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root.parent / cfg_entry["file"])
    mix = load_json(root / "mixes" / f"{w['traffic']}.json")
    limits = load_json(root / "limits" / f"{w['config']}.{mix['kind']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(workload, config, mix, limits, e2e, per_layer,
                int(w["chips"]))


def metric_reader(name: str, root: pathlib.Path = PERFBENCH):
    """``read(ctx)`` of ``metrics/<name>.py`` (names may hold dots, so
    the file is loaded by path)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

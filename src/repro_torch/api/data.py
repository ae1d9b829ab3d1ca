"""Data sources behind one protocol (the port of ``repro/api/data.py``;
the same arrays for the same ``DataCfg``).

A data source is ``fn(cfg: DataCfg) -> InteractionData``; ``load_data``
applies the spec's held-out split on top.  The built-ins cover the
repo's three generators (synthetic paper-statistics graphs, explicit
bipartite sizes, Kronecker expansion); ``register_data_source`` lets a
new scenario plug in a loader without touching the engine — the spec
just names it.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.api.spec import DataCfg
from repro_torch.data import synth
from repro_torch.data.synth import InteractionData

DataSource = Callable[[DataCfg], InteractionData]

DATA_SOURCES: dict[str, DataSource] = {}


def register_data_source(name: str, fn: DataSource) -> None:
    DATA_SOURCES[name] = fn


def _synth(cfg: DataCfg) -> InteractionData:
    return synth.scaled(cfg.dataset, cfg.edges, seed=cfg.seed)


def _bipartite(cfg: DataCfg) -> InteractionData:
    if cfg.n_users is None or cfg.n_items is None:
        raise ValueError("source='bipartite' needs DataCfg.n_users and "
                         "DataCfg.n_items")
    return synth.generate_bipartite(cfg.n_users, cfg.n_items, cfg.edges,
                                    seed=cfg.seed)


def _kronecker(cfg: DataCfg) -> InteractionData:
    from repro_torch.data.kronecker import expand_by_factor
    base = synth.scaled(cfg.dataset, cfg.edges, seed=cfg.seed)
    if cfg.expand_factor <= 1:
        return base
    return expand_by_factor(base, cfg.expand_factor, seed=cfg.seed)


register_data_source("synth", _synth)
register_data_source("bipartite", _bipartite)
register_data_source("kronecker", _kronecker)


def load_data(cfg: DataCfg) -> tuple[InteractionData, InteractionData | None]:
    """(train, holdout) for a DataCfg.  ``test_frac=0`` means the whole
    graph trains and there is no holdout (e.g. timing-only runs)."""
    if cfg.source not in DATA_SOURCES:
        raise KeyError(f"unknown data source {cfg.source!r}; known: "
                       f"{sorted(DATA_SOURCES)}")
    data = DATA_SOURCES[cfg.source](cfg)
    if cfg.test_frac <= 0.0:
        return data, None
    return synth.train_test_split(data, cfg.test_frac, seed=cfg.seed)

"""Model registry (the port of ``repro/pipeline/registry.py``; LightGCN in
this slice, NGCF and GCN with later ones).

    init(seed, n_users, n_items, embed_dim, n_layers, device) -> params
    forward(params, g: BipartiteCSR, n_layers) -> (user_emb, item_emb)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import lightgcn as _lightgcn
from repro_torch.pipeline.sparse import BipartiteCSR


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable          # (seed, n_users, n_items, embed_dim, n_layers, device)
    forward: Callable       # (params, g, n_layers) -> (user_emb, item_emb)


def _lightgcn_init(seed, n_users, n_items, embed_dim, n_layers, device="cuda"):
    del n_layers
    return _lightgcn.init_params(seed, n_users, n_items, embed_dim,
                                 device=device)


def _lightgcn_forward(params, g: BipartiteCSR, n_layers: int):
    """Final embeddings = mean over the layer outputs {x^(0) .. x^(L)}."""
    xu, xi = params["user_embed"], params["item_embed"]
    acc_u, acc_i = xu, xi
    for _ in range(n_layers):
        xu, xi = g.sym_propagate(xu, xi)
        acc_u = acc_u + xu
        acc_i = acc_i + xi
    denom = n_layers + 1
    return acc_u / denom, acc_i / denom


MODELS = {
    "lightgcn": ModelSpec("lightgcn", _lightgcn_init, _lightgcn_forward),
}


def get_model(name: str) -> ModelSpec:
    if name not in MODELS:
        raise KeyError(f"unknown pipeline model {name!r}; "
                       f"known: {sorted(MODELS)}")
    return MODELS[name]

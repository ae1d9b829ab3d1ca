"""LightGCN (He et al., SIGIR'20) on the seed COO path: NGCF minus
W1/W2/nonlinearity; final embedding = mean over layer outputs.  The port
of ``repro/core/lightgcn.py``.

``init_params`` is the reference's seeded initialisation — N(0,
1/embed_dim) user and item tables.  A ``torch.Generator`` does not give
``jax.random``'s numbers: to share a state with the reference, load it
with ``repro_torch.convert.params_from_jax``."""
from __future__ import annotations

import math

import torch

from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.message_passing import (bipartite_sym_coeff,
                                              lightgcn_propagate_bipartite)
from repro_torch.device import resolve_device


def init_params(seed: int, n_users: int, n_items: int, embed_dim: int,
                device="cuda") -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    scale = 1.0 / math.sqrt(embed_dim)

    def table(n):
        return torch.randn((n, embed_dim), generator=gen, device=dev,
                           dtype=torch.float32) * scale

    return {"user_embed": table(n_users), "item_embed": table(n_items)}


def forward(params, g: BipartiteGraph, n_layers: int = 2):
    """Returns (user_final, item_final) = mean over {x^(0)..x^(L)}."""
    coeff = bipartite_sym_coeff(g)
    xu, xi = params["user_embed"], params["item_embed"]
    acc_u, acc_i = xu, xi
    for _ in range(n_layers):
        xu, xi = lightgcn_propagate_bipartite(g, xu, xi, coeff)
        acc_u = acc_u + xu
        acc_i = acc_i + xi
    denom = n_layers + 1
    return acc_u / denom, acc_i / denom

"""LightGCN (He et al., SIGIR 2020, arXiv:2002.02126): no weights, no
nonlinearity; each layer is the symmetric-normalised neighbourhood sum,
and the final embedding is the mean of the layer outputs x^(0)..x^(L).

``init`` draws the tables as the configuration states them: N(0,
1/embed_dim), users then items, from one ``torch.Generator`` seeded with
the run's seed on the device.
"""
from __future__ import annotations

import math

import torch


def init(seed: int, n_users: int, n_items: int, embed_dim: int,
         n_layers: int, device) -> dict:
    del n_layers
    gen = torch.Generator(device=device).manual_seed(int(seed))
    scale = 1.0 / math.sqrt(embed_dim)

    def table(n):
        return torch.randn((n, embed_dim), generator=gen, device=device,
                           dtype=torch.float32) * scale

    return {"user_embed": table(n_users), "item_embed": table(n_items)}


def forward(params: dict, graph, n_layers: int):
    xu, xi = params["user_embed"], params["item_embed"]
    acc_u, acc_i = xu, xi
    for _ in range(n_layers):
        xu, xi = graph.sym_propagate(xu, xi)
        acc_u = acc_u + xu
        acc_i = acc_i + xi
    return acc_u / (n_layers + 1), acc_i / (n_layers + 1)

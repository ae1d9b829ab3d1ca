"""NGCF (Wang et al., SIGIR 2019, arXiv:1905.08108) in the form the
paper under study trains (arXiv:2207.11918 §4): per layer

    h_i = (sum_{u in N(i)} x_u ⊙ x_i) W1 + (sum_{u in N(i)} x_u) W2
    x_i' = LeakyReLU_0.2(h_i), and the same for users,

with no degree normalisation and no self term; the final embedding is
the concatenation of x^(0)..x^(L).  The Hadamard sum factors: every edge
into i multiplies by the same x_i, so it is x_i ⊙ (sum_u x_u).  Departure
from the original NGCF: its 1/sqrt(|N_u||N_i|) weights, self-connection
and dropout are absent here, as in the system measured.

``init`` draws as the configuration states: N(0, 1/embed_dim) tables,
users then items, then per layer W1 then W2 with the same scale, from
one ``torch.Generator`` seeded with the run's seed on the device.
"""
from __future__ import annotations

import math

import torch


def init(seed: int, n_users: int, n_items: int, embed_dim: int,
         n_layers: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    scale = 1.0 / math.sqrt(embed_dim)

    def normal(rows):
        return torch.randn((rows, embed_dim), generator=gen, device=device,
                           dtype=torch.float32) * scale

    params = {"user_embed": normal(n_users), "item_embed": normal(n_items),
              "w1": [], "w2": []}
    for _ in range(n_layers):
        params["w1"].append(normal(embed_dim))
        params["w2"].append(normal(embed_dim))
    return params


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def forward(params: dict, graph, n_layers: int):
    xu, xi = params["user_embed"], params["item_embed"]
    outs_u, outs_i = [xu], [xi]
    for w1, w2 in zip(params["w1"][:n_layers], params["w2"][:n_layers]):
        s_i = graph.agg_u2i(xu)
        s_u = graph.agg_i2u(xi)
        h_i = (xi * s_i) @ w1 + s_i @ w2
        h_u = (xu * s_u) @ w1 + s_u @ w2
        xu, xi = _leaky(h_u), _leaky(h_i)
        outs_u.append(xu)
        outs_i.append(xi)
    return torch.cat(outs_u, -1), torch.cat(outs_i, -1)

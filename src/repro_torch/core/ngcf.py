"""NGCF (Wang et al., SIGIR'19) as the paper uses it, on the seed COO path:
Eq (4)-(6) with the three §4 dataflow optimizations (``opt_level``);
final embedding = concat over layers; BPR-trained.  The port of
``repro/core/ngcf.py``.

``init_params`` is the reference's seeded initialisation in the same
layout — N(0, 1/embed_dim) user and item tables and per-layer
``w1``/``w2`` lists of [embed_dim, embed_dim] matrices with the same
scale.  A ``torch.Generator`` does not give ``jax.random``'s numbers: to
share a state with the reference, load it with ``repro_torch.convert``."""
from __future__ import annotations

import math

import torch

from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.message_passing import ngcf_propagate_bipartite
from repro_torch.device import resolve_device


def init_params(seed: int, n_users: int, n_items: int, embed_dim: int,
                n_layers: int, device="cuda") -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    scale = 1.0 / math.sqrt(embed_dim)

    def normal(rows):
        return torch.randn((rows, embed_dim), generator=gen, device=dev,
                           dtype=torch.float32) * scale

    params = {"user_embed": normal(n_users), "item_embed": normal(n_items),
              "w1": [], "w2": []}
    for _ in range(n_layers):
        params["w1"].append(normal(embed_dim))
        params["w2"].append(normal(embed_dim))
    return params


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: where(x >= 0, x, slope * x); gradient 1 at 0."""
    return torch.where(x >= 0, x, slope * x)


def forward(params, g: BipartiteGraph, opt_level: int = 3,
            impl: str | None = None):
    """Returns (user_final, item_final): concat of all layer embeddings,
    shape [n, (L+1)*D]."""
    xu, xi = params["user_embed"], params["item_embed"]
    outs_u, outs_i = [xu], [xi]
    for w1, w2 in zip(params["w1"], params["w2"]):
        xu, xi = ngcf_propagate_bipartite(g, xu, xi, w1, w2,
                                          opt_level=opt_level, impl=impl)
        xu = leaky_relu(xu, 0.2)
        xi = leaky_relu(xi, 0.2)
        outs_u.append(xu)
        outs_i.append(xi)
    return torch.cat(outs_u, -1), torch.cat(outs_i, -1)


def n_layers(params) -> int:
    return len(params["w1"])

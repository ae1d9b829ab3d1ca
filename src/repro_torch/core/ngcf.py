"""NGCF (Wang et al., SIGIR'19) parameters: the seeded initialisation of
``repro/core/ngcf.py::init_params`` in the same layout — N(0, 1/embed_dim)
user and item tables and per-layer ``w1``/``w2`` lists of
[embed_dim, embed_dim] matrices with the same scale.  A
``torch.Generator`` does not give ``jax.random``'s numbers: to share a
state with the reference, load it with ``repro_torch.convert``."""
from __future__ import annotations

import math

import torch

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

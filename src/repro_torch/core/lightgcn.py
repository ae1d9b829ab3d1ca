"""LightGCN (He et al., SIGIR'20) parameters: the seeded initialisation of
``repro/core/lightgcn.py::init_params`` — N(0, 1/embed_dim) user and item
tables.  A ``torch.Generator`` does not give ``jax.random``'s numbers:
to share a state with the reference, load it with
``repro_torch.convert.params_from_jax``."""
from __future__ import annotations

import math

import torch

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

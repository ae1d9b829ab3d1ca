"""Model registry (the port of ``repro/pipeline/registry.py``).

    init(seed, n_users, n_items, embed_dim, n_layers, device) -> params
    forward(params, g: BipartiteCSR, n_layers) -> (user_emb, item_emb)

  lightgcn — He et al. SIGIR'20: mean over the layer outputs.
  ngcf     — Wang et al. SIGIR'19 with the paper's §4 rewrites: the
             Hadamard messages through the fused ``hadamard_agg_*`` ops
             (no [E, D] matrix) or, composed, one [E, D] product per
             layer reused for both directions; node-level matmuls.
  gcn      — sym-normalised propagate + per-layer weight + ReLU.
  dgcf     — Wang et al. SIGIR'20 (arXiv:2007.01764): K intent chunks,
             per-edge routing over them refined by T iterations a layer
             (``core/dgcf.py``; the published K = 4, T = 2); LightGCN's
             tables, draw and layer mean.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.core import dgcf as _dgcf
from repro_torch.core import lightgcn as _lightgcn
from repro_torch.core import ngcf as _ngcf
from repro_torch.device import resolve_device
from repro_torch.pipeline.sparse import BipartiteCSR


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable          # (seed, n_users, n_items, embed_dim, n_layers, device)
    forward: Callable       # (params, g, n_layers) -> (user_emb, item_emb)
    materializes_messages: bool   # [E, embed_dim] edge matrix per layer
    concat_layers: bool = False   # output concatenates all layer embeddings

    def out_dim(self, embed_dim: int, n_layers: int) -> int:
        """Final embedding width."""
        return embed_dim * (n_layers + 1) if self.concat_layers else embed_dim

    def messages_materialized(self, g: "BipartiteCSR | None" = None) -> bool:
        """Whether this run's forward forms the per-layer [E, embed_dim]
        message matrix: the fused Hadamard route never does."""
        return self.materializes_messages \
            and not getattr(g, "fused_hadamard", False)


# ---------------------------------------------------------------- lightgcn
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


# ---------------------------------------------------------------- ngcf
def _ngcf_init(seed, n_users, n_items, embed_dim, n_layers, device="cuda"):
    return _ngcf.init_params(seed, n_users, n_items, embed_dim, n_layers,
                             device=device)


def _ngcf_forward(params, g: BipartiteCSR, n_layers: int):
    xu, xi = params["user_embed"], params["item_embed"]
    outs_u, outs_i = [xu], [xi]
    fused = getattr(g, "fused_hadamard", False)
    for w1, w2 in zip(params["w1"], params["w2"]):
        if fused:
            # fused gather-Hadamard-aggregate, rematerialising backward
            agg_mul_item = g.hadamard_agg_item(xu, xi)
            agg_mul_user = g.hadamard_agg_user(xi, xu)
        else:
            # one Hadamard product per layer, reused for both directions
            mul_ui = xu[g.ui_src] * xi[g.ui_dst]         # [E, D], ui order
            agg_mul_item = g.edge_agg_item(mul_ui)
            agg_mul_user = g.edge_agg_user(mul_ui[g.perm_ui_to_iu])
        # aggregate raw source features first, matmul at node level
        h_item = agg_mul_item @ w1 + g.agg_u2i(xu) @ w2
        h_user = agg_mul_user @ w1 + g.agg_i2u(xi) @ w2
        xu = _ngcf.leaky_relu(h_user, 0.2)
        xi = _ngcf.leaky_relu(h_item, 0.2)
        outs_u.append(xu)
        outs_i.append(xi)
    return torch.cat(outs_u, -1), torch.cat(outs_i, -1)


# ---------------------------------------------------------------- gcn
def _gcn_init(seed, n_users, n_items, embed_dim, n_layers, device="cuda"):
    """N(0, 1/embed_dim) tables; per layer a He-scaled [D, D] weight and a
    zero bias, in the reference's ``layers`` list of dicts."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def normal(rows, cols, std):
        return torch.randn((rows, cols), generator=gen, device=dev,
                           dtype=torch.float32) * std

    scale = 1.0 / math.sqrt(embed_dim)
    params = {"user_embed": normal(n_users, embed_dim, scale),
              "item_embed": normal(n_items, embed_dim, scale), "layers": []}
    for _ in range(n_layers):
        params["layers"].append({
            "w": normal(embed_dim, embed_dim, math.sqrt(2.0 / embed_dim)),
            "b": torch.zeros((embed_dim,), dtype=torch.float32, device=dev)})
    return params


def _gcn_forward(params, g: BipartiteCSR, n_layers: int):
    xu, xi = params["user_embed"], params["item_embed"]
    for l, lyr in enumerate(params["layers"]):
        hu, hi = g.sym_propagate(xu, xi)
        xu = hu @ lyr["w"] + lyr["b"]
        xi = hi @ lyr["w"] + lyr["b"]
        if l + 1 < len(params["layers"]):
            xu = torch.relu(xu)
            xi = torch.relu(xi)
    return xu, xi


MODELS = {
    "lightgcn": ModelSpec("lightgcn", _lightgcn_init, _lightgcn_forward,
                          materializes_messages=False),
    "ngcf": ModelSpec("ngcf", _ngcf_init, _ngcf_forward,
                      materializes_messages=True, concat_layers=True),
    "gcn": ModelSpec("gcn", _gcn_init, _gcn_forward,
                     materializes_messages=False),
    # the tables as LightGCN's; per-edge state is [E, K], no [E, D] matrix
    "dgcf": ModelSpec("dgcf", _lightgcn_init,
                      functools.partial(_dgcf.forward,
                                        n_factors=_dgcf.N_FACTORS,
                                        n_iterations=_dgcf.N_ITERATIONS),
                      materializes_messages=False),
}


def get_model(name: str) -> ModelSpec:
    if name not in MODELS:
        raise KeyError(f"unknown pipeline model {name!r}; "
                       f"known: {sorted(MODELS)}")
    return MODELS[name]

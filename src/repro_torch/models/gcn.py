"""GCN (Kipf & Welling, arXiv:1609.02907) — the port of
``repro/models/gcn.py``.

Four operating shapes:
  full_graph_sm / ogb_products : full-batch training (one SpMM per layer
    over the whole graph — the paper's single-machine full-graph regime);
  minibatch_lg : sampled-block training (fanout 15-10) — the DistDGL-style
    regime the paper compares against;
  molecule     : batched small graphs + mean readout.

GCN's message fn is a scalar-weighted copy, so message+aggregate fuse
into ONE SpMM (paper §9) — ``core.sparse_ops.gspmm_copy_sum`` with the
symmetric-norm coefficient.  Every aggregation is a ``segment_sum``
(``index_add_``, whose backward is the gather alone), outside any kernel,
as the reference's are outside any ``pallas_call``.

``init_params`` draws from a ``torch.Generator`` seeded by ``seed`` on
``device``: not ``jax.random``'s numbers; to share a state with the
reference, load it with ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.graph import Graph, sym_norm_coeff
from repro_torch.core.sparse_ops import gspmm_copy_sum, segment_sum
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    n_classes: int = 7
    d_feat: int = 1433
    dropout: float = 0.0   # eval-mode default; training uses rng arg


def init_params(cfg: GCNConfig, seed: int = 0, device="cuda") -> dict:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases, layer by
    layer, as the reference's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    layers = []
    for l in range(cfg.n_layers):
        w = torch.empty((dims[l], dims[l + 1]), dtype=torch.float32,
                        device=dev)
        layers.append({"w": w.normal_(0.0, math.sqrt(2.0 / dims[l]),
                                      generator=gen),
                       "b": torch.zeros((dims[l + 1],), dtype=torch.float32,
                                        device=dev)})
    return {"layers": layers}


def forward(cfg: GCNConfig, params, g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Full-graph forward: x [N, F] -> logits [N, C]."""
    coeff = sym_norm_coeff(g)
    for l, w in enumerate(params["layers"]):
        # aggregate-then-transform keeps the matmul at O(|V|) (paper O1)
        x = gspmm_copy_sum(x, g.src, g.dst, g.n_nodes, g.edge_mask, coeff)
        x = x @ w["w"] + w["b"]
        if l + 1 < cfg.n_layers:
            x = torch.relu(x)
    return x


def forward_blocks(cfg: GCNConfig, params, blocks, x: torch.Tensor
                   ) -> torch.Tensor:
    """Sampled-block forward (deepest block first); x aligns with
    blocks[0]'s src nodes.  Each block is a dict of ``edge_src``,
    ``edge_dst``, ``edge_mask`` and ``n_dst``; the aggregation is the mean
    over each dst node's live edges."""
    for l, (w, b) in enumerate(zip(params["layers"], blocks)):
        src, dst, mask = b["edge_src"], b["edge_dst"], b["edge_mask"]
        n_dst = b["n_dst"]
        m = torch.where(mask[:, None], x.index_select(0, src), 0.0)
        h = segment_sum(m, dst, n_dst)
        deg = segment_sum(mask.to(x.dtype), dst, n_dst)
        x = h / deg.clamp_min(1.0)[:, None]
        x = x @ w["w"] + w["b"]
        if l + 1 < cfg.n_layers:
            x = torch.relu(x)
    return x


def forward_batched(cfg: GCNConfig, params, src, dst, edge_mask, x,
                    graph_ids, n_graphs: int) -> torch.Tensor:
    """molecule shape: node-batched small graphs.
    x [B*n, F]; src/dst index into the flat node axis; graph_ids [B*n]."""
    n = x.shape[0]
    ones = edge_mask.to(torch.float32)
    deg_o = segment_sum(ones, src, n)
    deg_i = segment_sum(ones, dst, n)
    coeff = torch.rsqrt(deg_o.clamp_min(1.0)).index_select(0, src) \
        * torch.rsqrt(deg_i.clamp_min(1.0)).index_select(0, dst)
    coeff = torch.where(edge_mask, coeff, 0.0)
    for l, w in enumerate(params["layers"]):
        m = x.index_select(0, src) * coeff[:, None]
        m = torch.where(edge_mask[:, None], m, 0.0)
        x = segment_sum(m, dst, n)
        x = x @ w["w"] + w["b"]
        if l + 1 < cfg.n_layers:
            x = torch.relu(x)
    # mean readout per graph
    pooled = segment_sum(x, graph_ids, n_graphs)
    cnt = segment_sum(torch.ones((n,), dtype=torch.float32, device=x.device),
                      graph_ids, n_graphs)
    return pooled / cnt.clamp_min(1.0)[:, None]


def loss_fn(cfg: GCNConfig, params, g: Graph, x, labels, label_mask):
    """Masked mean negative log-likelihood of the full-graph logits."""
    logits = forward(cfg, params, g, x)
    logp = torch.log_softmax(logits, -1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    return -torch.sum(ll * label_mask) / label_mask.sum().clamp_min(1.0)

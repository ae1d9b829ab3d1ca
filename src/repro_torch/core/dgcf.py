"""DGCF — Disentangled Graph Collaborative Filtering (Wang, Jin, Zhang,
Yang, Zhang, Chua, SIGIR 2020, arXiv:2007.01764): the routing layer over
``BipartiteCSR``.

Each D-wide embedding is K intent chunks of d = D/K columns.  Every edge
carries one routing logit per intent and per direction: ``s_user`` [E, K]
on the user rows (iu edge order, aggregating items) and ``s_item`` on the
item rows (ui order), all 1 before the first layer.  One routing
iteration, for the user side (the item side is its mirror):

  P = softmax_k(S);  deg[u, k] = sum_{e in row u} P[e, k];  r = deg^(-1/2)
  (0 where deg is 0);
  h_u[u, chunk k] = r_u[u, k] sum_e P[e, k] r_i[i_e, k] x_i[i_e, chunk k]
  (r_i scales x before ``intent_spmm``, r_u the result after it);
  S[e, k] += <n(h_u[u_e, chunk k]), tanh(n(x_i[i_e, chunk k]))>
  (``intent_sddmm``), n the L2 normalisation of one chunk (eps 1e-12 on
  its norm), x the layer's input.

A layer runs ``n_iterations`` iterations and outputs the last one's h; S
carries into the next layer; the last update of the last layer is never
read and not computed.  The final embedding is the mean of the layer
outputs 0..L.  The normalisation inside the agreement, the mean over the
layers and the carried S are read from the authors' code (the paper
writes an unnormalised dot and a sum).  With one iteration P = 1/K and
deg = degree/K, so a layer is LightGCN's ``sym_propagate``.

The weights' backward is written out (``_IntentWeights``); the
aggregation's and the agreement's are ``BipartiteCSR``'s, on the same two
kernels; the rest is elementwise on [E, K] and [N, D] tensors.  No [E, D]
tensor exists forward or backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch import trace

# the published setting (DGCF-1): 4 intents, 2 routing iterations
N_FACTORS = 4
N_ITERATIONS = 2
# eps on a chunk's L2 norm in the agreement
EPS = 1e-12


class _IntentWeights(torch.autograd.Function):
    """(P, r) of one direction's routing logits S [E, K], in the edge
    order of ``g``'s CSR of ``side``'s rows: P = softmax over the intents
    of each edge; deg = the row sums of P (``spmm_csr`` over the edge
    values); r = deg^(-1/2), 0 where deg is 0.  Backward, written out:

      d_deg = -r³/2 · d_r;  d_P' = d_P + d_deg[row_e];
      d_S = P · (d_P' - sum_k P · d_P')
    """

    @staticmethod
    def forward(ctx, s, g, side, impl):
        indptr, rows, n = (g.iu_indptr, g.iu_dst, g.n_users) \
            if side == "user" else (g.ui_indptr, g.ui_dst, g.n_items)
        p = torch.softmax(s, dim=1)
        deg = kops.spmm_csr("sum", p, indptr, rows, n, gather=False,
                            impl=impl)
        r = torch.where(deg > 0, deg.rsqrt(), 0.0)
        ctx.save_for_backward(p, r)
        ctx.g, ctx.side = g, side
        return p, r

    @staticmethod
    def backward(ctx, d_p, d_r):
        p, r = ctx.saved_tensors
        d_deg = -0.5 * r * r * r * d_r
        d_p = d_p + ctx.g.rows_to_edges(d_deg, ctx.side)
        d_s = p * (d_p - (p * d_p).sum(1, keepdim=True))
        return d_s, None, None, None


def _weights(g, s: torch.Tensor, side: str):
    return _IntentWeights.apply(s, g, side, g.impl)


def _chunk_scale(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x [N, D] with chunk k of row v times r[v, k]."""
    n, k = r.shape
    return (x.view(n, k, -1) * r[:, :, None]).view(n, -1)


def _unit(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each of the K chunks of each row of x scaled to unit L2 norm."""
    n = x.shape[0]
    return F.normalize(x.view(n, k, -1), dim=-1, eps=EPS).view(n, -1)


def route(g, s_user: torch.Tensor, s_item: torch.Tensor, xu: torch.Tensor,
          xi: torch.Tensor):
    """One routing iteration's aggregation: (h_user, h_item)."""
    p_u, r_u = _weights(g, s_user, "user")
    p_i, r_i = _weights(g, s_item, "item")
    hu = _chunk_scale(g.intent_agg_user(p_u, _chunk_scale(xi, r_i)), r_u)
    hi = _chunk_scale(g.intent_agg_item(p_i, _chunk_scale(xu, r_u)), r_i)
    return hu, hi


def forward(params, g, n_layers: int, *, n_factors: int = N_FACTORS,
            n_iterations: int = N_ITERATIONS):
    """Final embeddings (user, item): the mean of the layer outputs
    {x^(0) .. x^(L)}."""
    xu, xi = params["user_embed"], params["item_embed"]
    k = int(n_factors)
    if xu.shape[1] % k:
        raise ValueError(f"{k} intents must divide the embedding width "
                         f"{xu.shape[1]}")
    if n_iterations < 1:
        raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
    ones = torch.ones((g.n_edges, k), dtype=xu.dtype, device=xu.device)
    s_user, s_item = ones, ones
    acc_u, acc_i = xu, xi
    for layer in range(n_layers):
        tanh_u = tanh_i = None
        for it in range(n_iterations):
            with trace.span("dgcf::route"):
                hu, hi = route(g, s_user, s_item, xu, xi)
            if layer == n_layers - 1 and it == n_iterations - 1:
                break
            with trace.span("dgcf::agree"):
                if tanh_u is None:
                    tanh_u = torch.tanh(_unit(xu, k))
                    tanh_i = torch.tanh(_unit(xi, k))
                s_user = s_user + g.intent_agree_user(_unit(hu, k), tanh_i, k)
                s_item = s_item + g.intent_agree_item(_unit(hi, k), tanh_u, k)
        xu, xi = hu, hi
        acc_u = acc_u + xu
        acc_i = acc_i + xi
    denom = n_layers + 1
    return acc_u / denom, acc_i / denom

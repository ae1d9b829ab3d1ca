"""DGCF, Disentangled Graph Collaborative Filtering (Wang, Jin, Zhang, Yang,
Zhang, Chua, SIGIR 2020, arXiv:2007.01764; the authors' code:
github.com/xiangwang1223/disentangled_graph_collaborative_filtering).

Each D-wide embedding is K intent chunks of D/K columns; chunk k of a row
is its columns [k·D/K, (k+1)·D/K), and n(v) scales one chunk to unit L2
norm (eps 1e-12 on the norm).  Every edge (u, i) carries a routing logit
per intent in each direction, S_u (the sum into u) and S_i (into i), all
1 before the first layer.  A layer takes (x_u, x_i) and runs
``n_iterations`` routing iterations; in each, for the sum into the users
(the items' is its mirror):

  P_u = softmax over k of S_u, per edge;
  deg_u[u, k] = sum of P_u[e, k] over u's edges;  r_u = deg_u^(-1/2), 0
  where deg_u is 0;
  h_u[u, chunk k] = r_u[u, k] · sum over u's edges of
                    P_u[e, k] · r_i[i_e, k] · x_i[i_e, chunk k];
  unless this is the last iteration of the last layer:
  S_u[e, k] += <n(h_u[u_e, chunk k]), tanh(n(x_i[i_e, chunk k]))>.

The layer outputs the last iteration's h; S carries into the next layer;
the final embedding is the mean of the layer outputs 0..L.  From the
authors' code rather than the paper's equations: the normalisation
inside the agreement (the paper writes a plain dot), the mean over the
layers (a sum) and S carried across layers.  Departures (the
configuration's ``assumed``): no independence (distance-correlation)
term, L2 on the gathered rows as for every model, and ``init``, LightGCN's
N(0, 1/D) draw rather than Xavier.

Edges are taken in blocks of ``BLOCK``, each block's [edges, D] gather
under a checkpoint, so autograd keeps only [E, K] per-edge state and the
tables, and the block's rows are gathered again in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import lightgcn

# the published setting (DGCF-1): 4 intents, 2 routing iterations
N_FACTORS = 4
N_ITERATIONS = 2
EPS = 1e-12
BLOCK = 1 << 22


def init(seed: int, n_users: int, n_items: int, embed_dim: int,
         n_layers: int, device) -> dict:
    """LightGCN's tables and draw."""
    return lightgcn.init(seed, n_users, n_items, embed_dim, n_layers, device)


def _chunks(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.reshape(x.shape[0], k, -1)


def _unit(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.normalize(_chunks(x, k), dim=-1, eps=EPS).flatten(1)


def _scale(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Chunk k of row v of x times r[v, k]."""
    return (_chunks(x, r.shape[1]) * r[:, :, None]).flatten(1)


def _messages(x, idx, w):
    return (_chunks(x[idx], w.shape[1]) * w[:, :, None]).flatten(1)


def _dots(a, b, ia, ib, k):
    return (_chunks(a[ia], k) * _chunks(b[ib], k)).sum(-1)


def _sum_into(x, w, src, dst, n_dst):
    """out[v, chunk k] = sum over the edges e into v of w[e, k] ·
    x[src_e, chunk k]."""
    out = torch.zeros((n_dst, x.shape[1]), dtype=x.dtype, device=x.device)
    for lo in range(0, src.numel(), BLOCK):
        blk = slice(lo, lo + BLOCK)
        m = checkpoint(_messages, x, src[blk], w[blk], use_reentrant=False)
        out = out.index_add(0, dst[blk], m)
    return out


def _agreement(a, b, ia, ib, k):
    """s[e, k] = <a[ia_e, chunk k], b[ib_e, chunk k]>."""
    return torch.cat([checkpoint(_dots, a, b, ia[lo:lo + BLOCK],
                                 ib[lo:lo + BLOCK], k, use_reentrant=False)
                      for lo in range(0, ia.numel(), BLOCK)])


def _weights(s, rows, n_rows):
    """(P, r): the softmax over the intents and the inverse square root
    of the degrees it gives the rows (0 for a row with no edge)."""
    p = torch.softmax(s, dim=1)
    deg = torch.zeros((n_rows, s.shape[1]), dtype=s.dtype,
                      device=s.device).index_add(0, rows, p)
    tiny = torch.finfo(deg.dtype).tiny
    return p, torch.where(deg > 0, deg.clamp_min(tiny).rsqrt(), 0.0)


def forward(params: dict, graph, n_layers: int, n_factors: int = N_FACTORS,
            n_iterations: int = N_ITERATIONS):
    xu, xi = params["user_embed"], params["item_embed"]
    k = n_factors
    u, i = graph.user, graph.item
    s_u = torch.ones((u.numel(), k), dtype=xu.dtype, device=xu.device)
    s_i = s_u
    acc_u, acc_i = xu, xi
    for layer in range(n_layers):
        tanh_u, tanh_i = torch.tanh(_unit(xu, k)), torch.tanh(_unit(xi, k))
        for t in range(n_iterations):
            p_u, r_u = _weights(s_u, u, graph.n_users)
            p_i, r_i = _weights(s_i, i, graph.n_items)
            hu = _scale(_sum_into(_scale(xi, r_i), p_u, i, u, graph.n_users),
                        r_u)
            hi = _scale(_sum_into(_scale(xu, r_u), p_i, u, i, graph.n_items),
                        r_i)
            if layer < n_layers - 1 or t < n_iterations - 1:
                s_u = s_u + _agreement(_unit(hu, k), tanh_i, u, i, k)
                s_i = s_i + _agreement(_unit(hi, k), tanh_u, i, u, k)
        xu, xi = hu, hi
        acc_u = acc_u + xu
        acc_i = acc_i + xi
    return acc_u / (n_layers + 1), acc_i / (n_layers + 1)

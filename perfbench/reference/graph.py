"""Neighbourhood sums over the edge arrays, in blocks of edges.

``agg_u2i(x)[i] = sum of x[u] over the edges (u, i)`` and ``agg_i2u``
the other way, by gather and ``index_add`` over blocks of ``BLOCK``
edges, so a block's [edges, D] gather is the only temporary.  Autograd
saves only the index blocks.  LightGCN's normalisation 1/sqrt(d_u d_i)
(degrees counted over the train edges, at least 1) is applied at the
nodes, on both sides of the sum.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 22


class Graph:
    """The train edges of one cell, as the reference uses them."""

    def __init__(self, user: torch.Tensor, item: torch.Tensor,
                 n_users: int, n_items: int):
        self.user = user.to(torch.int64)
        self.item = item.to(torch.int64)
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        du = torch.bincount(self.user, minlength=n_users).float()
        di = torch.bincount(self.item, minlength=n_items).float()
        self.rs_u = du.clamp(min=1.0).rsqrt()
        self.rs_i = di.clamp(min=1.0).rsqrt()

    @staticmethod
    def _sum(x, src, dst, n_dst):
        out = torch.zeros((n_dst, x.shape[1]), dtype=x.dtype, device=x.device)
        for lo in range(0, src.numel(), BLOCK):
            out = out.index_add(0, dst[lo:lo + BLOCK], x[src[lo:lo + BLOCK]])
        return out

    def agg_u2i(self, x_user: torch.Tensor) -> torch.Tensor:
        return self._sum(x_user, self.user, self.item, self.n_items)

    def agg_i2u(self, x_item: torch.Tensor) -> torch.Tensor:
        return self._sum(x_item, self.item, self.user, self.n_users)

    def sym_propagate(self, xu: torch.Tensor, xi: torch.Tensor):
        """One normalised layer: h_i = sum_u x_u / sqrt(d_u d_i), and the
        same for users."""
        ru = self.rs_u.to(xu.dtype)[:, None]
        ri = self.rs_i.to(xi.dtype)[:, None]
        h_item = self.agg_u2i(xu * ru) * ri
        h_user = self.agg_i2u(xi * ri) * ru
        return h_user, h_item

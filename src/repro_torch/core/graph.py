"""COO graph containers (the port of ``repro/core/graph.py``).

Edge lists padded to a fixed budget with a per-edge validity mask; the
host arrays are the reference's byte for byte.  Where the reference keeps
padded shapes so that ``jit`` traces once, the port keeps them so that the
same graphs and masks flow through both packages.  A bipartite user-item
graph stores each interaction once as (user, item), item ids in
[0, n_items); ``as_homogeneous`` re-bases items to [n_users, n_users +
n_items) and emits both edge directions.  Tensors lie on one device,
given by ``device`` (default "cuda").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.sddmm import EdgeGroups, group_edges


@dataclasses.dataclass(frozen=True)
class Graph:
    """COO graph: src/dst i32[E_pad] endpoints, edge_mask bool[E_pad]
    (False on padding), n_nodes and n_edges (real edges)."""

    src: torch.Tensor
    dst: torch.Tensor
    edge_mask: torch.Tensor
    n_nodes: int
    n_edges: int

    @property
    def e_pad(self) -> int:
        return self.src.shape[0]

    def reverse(self) -> "Graph":
        return Graph(self.dst, self.src, self.edge_mask, self.n_nodes,
                     self.n_edges)


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """User-item interactions: user/item i32[E_pad], edge_mask bool[E_pad]."""

    user: torch.Tensor
    item: torch.Tensor
    edge_mask: torch.Tensor
    n_users: int
    n_items: int
    n_edges: int
    _user_groups: EdgeGroups | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def e_pad(self) -> int:
        return self.user.shape[0]

    def user_groups(self) -> EdgeGroups:
        """The edges grouped by user (``kernels.sddmm.group_edges``: one
        sort on the graph's device), built on the first call and kept, so
        that every layer, step and level reuses them."""
        if self._user_groups is None:
            object.__setattr__(self, "_user_groups", group_edges(
                self.user, self.item, self.edge_mask))
        return self._user_groups

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    def as_homogeneous(self) -> Graph:
        src = torch.cat([self.user, self.item + self.n_users])
        dst = torch.cat([self.item + self.n_users, self.user])
        mask = torch.cat([self.edge_mask, self.edge_mask])
        return Graph(src, dst, mask, self.n_nodes, 2 * self.n_edges)


def pad_edges(src: np.ndarray, dst: np.ndarray, e_pad: int):
    """Pad (src, dst) to e_pad entries; padded edges point at node 0 and
    are masked out."""
    e = src.shape[0]
    if e > e_pad:
        raise ValueError(f"{e} edges exceed pad budget {e_pad}")
    mask = np.zeros(e_pad, dtype=bool)
    mask[:e] = True
    out_src = np.zeros(e_pad, dtype=np.int32)
    out_dst = np.zeros(e_pad, dtype=np.int32)
    out_src[:e] = src
    out_dst[:e] = dst
    return out_src, out_dst, mask


def from_numpy(src: np.ndarray, dst: np.ndarray, n_nodes: int,
               e_pad: int | None = None, device="cuda") -> Graph:
    dev = resolve_device(device)
    e_pad = e_pad or len(src)
    s, d, m = pad_edges(np.asarray(src), np.asarray(dst), e_pad)
    return Graph(to_device(s, dev), to_device(d, dev), to_device(m, dev),
                 int(n_nodes), int(len(src)))


def bipartite_from_numpy(user: np.ndarray, item: np.ndarray, n_users: int,
                         n_items: int, e_pad: int | None = None,
                         device="cuda") -> BipartiteGraph:
    dev = resolve_device(device)
    e_pad = e_pad or len(user)
    u, i, m = pad_edges(np.asarray(user), np.asarray(item), e_pad)
    return BipartiteGraph(to_device(u, dev), to_device(i, dev),
                          to_device(m, dev), int(n_users), int(n_items),
                          int(len(user)))


def degrees(src: torch.Tensor, edge_mask: torch.Tensor,
            n_nodes: int) -> torch.Tensor:
    """Out-degree per node (or in-degree if called with dst), float32."""
    ones = edge_mask.to(torch.float32)
    return torch.zeros(n_nodes, dtype=torch.float32,
                       device=src.device).index_add_(0, src, ones)


def sym_norm_coeff(g: Graph) -> torch.Tensor:
    """GCN symmetric normalization 1/sqrt(d_src * d_dst) per edge."""
    d_out = degrees(g.src, g.edge_mask, g.n_nodes).clamp_min(1.0)
    d_in = degrees(g.dst, g.edge_mask, g.n_nodes).clamp_min(1.0)
    coeff = torch.rsqrt(d_out.index_select(0, g.src)) \
        * torch.rsqrt(d_in.index_select(0, g.dst))
    return torch.where(g.edge_mask, coeff, 0.0)


def to_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Host-side CSR build (row = src).  Returns (indptr, indices, perm)
    where perm maps sorted-edge order back to input order."""
    perm = np.argsort(src, kind="stable")
    s = src[perm]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, s + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst[perm].astype(np.int32), perm

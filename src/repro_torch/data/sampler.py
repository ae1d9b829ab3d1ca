"""K-hop neighbour sampling (host side, numpy) — the port of
``repro/data/sampler.py``, byte for byte under one ``np.random.Generator``.

The consumer is the DistDGL-style subgraph-training baseline (paper
§2.2/§7.2, ``dist/subgraph.py``): per-batch message-flow blocks and the
cross-batch *redundancy* the paper measures (the same vertex appearing in
many subgraphs).  Blocks are padded to a multiple of ``pad_multiple``
edges, as the reference pads them for static shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # int64[N+1]
    indices: np.ndarray  # int32[E]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    def degree(self, v) -> np.ndarray:
        return self.indptr[np.asarray(v) + 1] - self.indptr[np.asarray(v)]


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    """CSR over incoming edges: row v lists the *sources* of edges into v."""
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.bincount(dst, minlength=n_nodes)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(indptr, src[order].astype(np.int32))


@dataclasses.dataclass
class Block:
    """One sampled message-passing hop: edges from src_nodes -> dst_nodes,
    with indices local to the respective node lists."""
    src_nodes: np.ndarray   # global ids, int32[n_src]
    dst_nodes: np.ndarray   # global ids, int32[n_dst]
    edge_src: np.ndarray    # local into src_nodes, int32[E_pad]
    edge_dst: np.ndarray    # local into dst_nodes, int32[E_pad]
    edge_mask: np.ndarray   # bool[E_pad]
    n_src: int
    n_dst: int


def sample_blocks(g: CSRGraph, seeds: np.ndarray, fanouts: list[int | None],
                  rng: np.random.Generator,
                  pad_multiple: int = 64) -> list[Block]:
    """Layered sampling (GraphSAGE-style), deepest hop first in the
    returned list.  fanout=None means full neighbourhood (no sampling),
    the paper's 'DistDGL w/o sampling' configuration.  The per-node loop
    and its order of ``rng.choice`` calls are the reference's: another
    order draws another random stream, and other blocks."""
    blocks: list[Block] = []
    frontier = np.unique(seeds.astype(np.int32))
    for fanout in fanouts:
        edge_src_g = []
        edge_dst_l = []
        for li, v in enumerate(frontier):
            lo, hi = g.indptr[v], g.indptr[v + 1]
            neigh = g.indices[lo:hi]
            if fanout is not None and len(neigh) > fanout:
                neigh = rng.choice(neigh, fanout, replace=False)
            edge_src_g.append(neigh)
            edge_dst_l.append(np.full(len(neigh), li, dtype=np.int32))
        edge_src_g = np.concatenate(edge_src_g) if edge_src_g \
            else np.zeros(0, np.int32)
        edge_dst_l = np.concatenate(edge_dst_l) if edge_dst_l \
            else np.zeros(0, np.int32)
        # src node list = frontier ∪ sampled neighbours (self rows keep
        # the residual/update path simple)
        src_nodes, inverse = np.unique(
            np.concatenate([frontier, edge_src_g]), return_inverse=True)
        edge_src_l = inverse[len(frontier):].astype(np.int32)
        e = len(edge_src_l)
        e_pad = max(pad_multiple,
                    int(np.ceil(e / pad_multiple)) * pad_multiple)
        blocks.append(Block(
            src_nodes=src_nodes.astype(np.int32),
            dst_nodes=frontier.copy(),
            edge_src=_pad(edge_src_l, e_pad),
            edge_dst=_pad(edge_dst_l, e_pad),
            edge_mask=_pad(np.ones(e, bool), e_pad),
            n_src=len(src_nodes), n_dst=len(frontier)))
        frontier = src_nodes.astype(np.int32)
    blocks.reverse()  # deepest hop first: apply layer L on block[0]
    return blocks


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=a.dtype)
    out[: len(a)] = a
    return out


def subgraph_redundancy(all_blocks: list[list[Block]]) -> float:
    """Paper Fig 2 metric: (sum of per-batch expanded vertex counts) /
    (count of unique vertices touched) — 1.0 means no redundancy."""
    total = 0
    seen: set[int] = set()
    for blocks in all_blocks:
        verts = np.unique(np.concatenate([b.src_nodes[:b.n_src]
                                          for b in blocks]))
        total += len(verts)
        seen.update(verts.tolist())
    return total / max(len(seen), 1)

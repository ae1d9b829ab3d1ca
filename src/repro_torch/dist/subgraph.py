"""DistDGL-style subgraph training baseline (paper §2.2 / §7.2) — the port
of ``repro/dist/subgraph.py``.

Single-machine full-graph training is the paper's headline winner; this
module is what it wins against.  Each step builds k-hop sampled
message-flow blocks for the seed batch on the host (the cost the paper's
Fig 14 breaks down), runs a mean-aggregation GNN over the blocks on the
device of the embedding table, and backprops to that table with torch
autograd.  Per-batch block construction and the cross-batch vertex
redundancy (paper Fig 2) are both accounted.

``max_subgraph_batch`` is the paper's Table 5 analytic memory model: the
expanded-vertex count per seed grows ~f^L with depth, so the largest
batch that fits a memory budget collapses exponentially with depth.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.sparse_ops import segment_sum
from repro_torch.data.sampler import (build_csr, sample_blocks,
                                      subgraph_redundancy)


@dataclasses.dataclass
class StepStats:
    sample_s: float            # subgraph (block) construction time
    forward_s: float
    backward_s: float
    expanded_vertices: int     # unique vertices pulled in by sampling


def _block_forward(blocks_dev, x_all: torch.Tensor) -> torch.Tensor:
    """Mean-aggregation over the sampled blocks, deepest hop first.
    Returns seed-node embeddings [n_seeds, D]."""
    h = x_all.index_select(0, blocks_dev[0]["src_nodes"])
    for b in blocks_dev:
        src, dst, mask = b["edge_src"], b["edge_dst"], b["edge_mask"]
        n_dst = b["dst_nodes"].shape[0]
        m = torch.where(mask[:, None], h.index_select(0, src), 0.0)
        agg = segment_sum(m, dst, n_dst)
        deg = segment_sum(mask.to(h.dtype), dst, n_dst)
        # self + mean-of-neighbours keeps the update well-defined on
        # zero-degree frontier nodes (dst_pos maps dst rows into the
        # sorted-unique src_nodes row order of h)
        h = 0.5 * h.index_select(0, b["dst_pos"]) \
            + 0.5 * agg / deg.clamp_min(1.0)[:, None]
    return h


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SubgraphTrainer:
    """Simulated n-worker DistDGL trainer on one host.

    The seed batch is split across ``n_workers``; each worker samples its
    own blocks (the paper's per-trainer subgraph construction) and the
    per-step stats aggregate across workers.  ``redundancy()`` reports
    the paper's Fig 2 metric over every batch stepped so far.  The blocks
    go to the device of the ``x_all`` a step is given.
    """

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int,
                 n_layers: int = 2, fanout: int | None = 10,
                 n_workers: int = 1, seed: int = 0):
        self.g = build_csr(np.asarray(src), np.asarray(dst), n_nodes)
        self.n_nodes = n_nodes
        self.n_layers = n_layers
        self.fanout = fanout
        self.n_workers = max(1, n_workers)
        self.rng = np.random.default_rng(seed)
        self._batches: list = []   # per-batch block lists, for redundancy

    def step(self, seeds: np.ndarray, x_all: torch.Tensor, loss_fn,
             record: bool = True):
        """One training step: sample blocks, forward, backward.

        loss_fn(seed_embeddings, seed_ids) -> scalar tensor.  Returns
        (grads w.r.t. x_all, StepStats).  ``record=False`` keeps the batch
        out of the redundancy accounting (warm-up calls would otherwise
        double-count their vertices).  Times are host clock around
        synchronised work, as the reference times its blocked calls.
        """
        seeds = np.asarray(seeds, np.int32)
        fanouts = [self.fanout] * self.n_layers
        dev = x_all.device

        t0 = time.perf_counter()
        worker_blocks = []
        for w in range(self.n_workers):
            part = seeds[w::self.n_workers]
            if len(part) == 0:
                continue
            worker_blocks.append(
                sample_blocks(self.g, part, fanouts, self.rng))
        sample_s = time.perf_counter() - t0
        if record:
            self._batches.extend(worker_blocks)
        expanded = int(sum(
            len(np.unique(np.concatenate(
                [b.src_nodes[:b.n_src] for b in blocks])))
            for blocks in worker_blocks))

        # device-tensor conversion is part of subgraph construction
        # (DistDGL builds block tensors per batch), so it counts toward
        # sample_s
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        t1 = time.perf_counter()
        bd_all = [[{"src_nodes": put(b.src_nodes),
                    "dst_nodes": put(b.dst_nodes),
                    "dst_pos": put(np.searchsorted(
                        b.src_nodes[:b.n_src], b.dst_nodes).astype(np.int32)),
                    "edge_src": put(b.edge_src),
                    "edge_dst": put(b.edge_dst),
                    "edge_mask": put(b.edge_mask)}
                   for b in blocks]
                  for blocks in worker_blocks]
        _sync(dev)
        sample_s += time.perf_counter() - t1

        def total_loss(x):
            losses = [loss_fn(_block_forward(bd, x), bd[-1]["dst_nodes"])
                      for bd in bd_all]
            return sum(losses) / len(losses)

        t2 = time.perf_counter()
        with torch.no_grad():
            total_loss(x_all)
        _sync(dev)
        forward_s = time.perf_counter() - t2

        # one value-and-grad is what a real step runs; subtract the
        # measured forward so (forward_s + backward_s) ~= its wall time
        # instead of double-counting the forward recompute
        t3 = time.perf_counter()
        x = x_all.detach().requires_grad_(True)
        with torch.enable_grad():
            (grads,) = torch.autograd.grad(total_loss(x), x)
        _sync(dev)
        backward_s = max(time.perf_counter() - t3 - forward_s, 1e-9)
        return grads, StepStats(sample_s, forward_s, backward_s, expanded)

    def redundancy(self) -> float:
        """Paper Fig 2: total expanded vertices / unique vertices."""
        return subgraph_redundancy(self._batches)


def max_subgraph_batch(n_nodes_est_per_seed: float, embed_dim: int,
                       n_layers: int, mem_bytes: float,
                       fanout: int | None, avg_degree: float,
                       bytes_per_value: int = 4,
                       train_multiplier: float = 4.0) -> int:
    """Paper Table 5 analytic model: the largest seed batch whose expanded
    subgraph (activations + grads across layers) fits ``mem_bytes``.

    The frontier grows by min(fanout, avg_degree) per hop, so vertices
    per seed ~ sum_{l<=L} f^l — exponential in depth.  fanout=None is the
    'DistDGL w/o sampling' configuration (full neighbourhood, f=degree).
    """
    f = float(avg_degree if fanout is None else min(fanout, avg_degree))
    verts_per_seed = n_nodes_est_per_seed * sum(
        f ** l for l in range(n_layers + 1))
    # per expanded vertex: one activation row per layer boundary, doubled
    # for grads (train_multiplier folds grads + optimizer temps in)
    bytes_per_seed = (verts_per_seed * embed_dim * bytes_per_value *
                      train_multiplier * (n_layers + 1))
    return max(int(mem_bytes // max(bytes_per_seed, 1.0)), 0)

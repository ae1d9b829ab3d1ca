"""Plain PyTorch versions of the port's kernels.

Each mirrors its oracle in ``repro/kernels/ref.py`` op for op.  They are
what a CPU tensor runs, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card.  They repeat the kernels' arithmetic and are no
yardstick of speed.
"""
from __future__ import annotations

import math

import torch

NEG_INF = float("-inf")


def spmm_csr_ref(reduce: str, values: torch.Tensor, indptr: torch.Tensor,
                 src_sorted: torch.Tensor, n_nodes: int,
                 gather: bool = False) -> torch.Tensor:
    """out[v] = reduce over e in [indptr[v], indptr[v+1]) of
    values[src_sorted[e]] (gather) or values[e]; an empty 'max' row is 0."""
    if reduce not in ("sum", "max"):
        raise ValueError(reduce)
    dev = values.device
    e = src_sorted.shape[0] if gather else values.shape[0]
    indptr = indptr.to(dev, torch.int64)
    # dst id per sorted edge from indptr
    dst = torch.searchsorted(indptr, torch.arange(e, device=dev),
                             right=True) - 1
    rows = values[src_sorted.to(dev).long()] if gather else values
    if e and int(dst[-1]) >= n_nodes:        # edges past the last row drop
        keep = dst < n_nodes
        dst, rows = dst[keep], rows[keep]
    d = values.shape[-1]
    if reduce == "sum":
        out = torch.zeros((n_nodes, d), dtype=values.dtype, device=dev)
        return out.index_add_(0, dst, rows)
    out = torch.full((n_nodes, d), NEG_INF, dtype=values.dtype, device=dev)
    out.scatter_reduce_(0, dst[:, None].expand_as(rows), rows, "amax")
    return torch.where(torch.isfinite(out), out, 0.0)


def hadamard_spmm_ref(x: torch.Tensor, y: torch.Tensor, indptr: torch.Tensor,
                      x_idx: torch.Tensor, y_idx: torch.Tensor, n_nodes: int,
                      scale: torch.Tensor | None = None,
                      slope: float | None = None) -> torch.Tensor:
    """Naive gather -> Hadamard -> scatter-sum: out[v] = sum over e in
    [indptr[v], indptr[v+1]) of x[x_idx[e]] * y[y_idx[e]], then
    ``* scale[:, None]`` and the leaky-relu ``v >= 0 ? v : v * slope``.
    It forms the [E, D] product the kernel avoids: a parity oracle only."""
    dev = x.device
    e = x_idx.shape[0]
    indptr = indptr.to(dev, torch.int64)
    dst = torch.searchsorted(indptr, torch.arange(e, device=dev),
                             right=True) - 1
    msgs = x.float()[x_idx.to(dev).long()] * y.float()[y_idx.to(dev).long()]
    if e and int(dst[-1]) >= n_nodes:        # edges past the last row drop
        keep = dst < n_nodes
        dst, msgs = dst[keep], msgs[keep]
    out = torch.zeros((n_nodes, x.shape[-1]), dtype=torch.float32, device=dev)
    out.index_add_(0, dst, msgs)
    if scale is not None:
        out = out * scale[:, None]
    if slope is not None:
        out = torch.where(out >= 0, out, out * slope)
    return out


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor, combiner: str = "sum") -> torch.Tensor:
    """out[b] = sum_l mask[b, l] * table[ids[b, l]]; 'mean' divides by
    max(count, 1)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(combiner)
    rows = table[ids.long()]                           # [B, L, D]
    rows = torch.where(mask[..., None], rows, 0.0)
    out = rows.sum(dim=1)
    if combiner == "mean":
        cnt = mask.sum(dim=1).clamp_min(1)
        out = out / cnt[:, None]
    return out


def ann_block_scores_ref(ue: torch.Tensor, centroids_q: torch.Tensor,
                         scale: torch.Tensor, radius: torch.Tensor
                         ) -> torch.Tensor:
    """Per-block score upper bounds ``(u · float(ĉ_b)) · scale_b + ‖u‖₂ ·
    radius_b`` over int8 block centroids, in the reference's op order.
    ue: f32[B, D]; centroids_q: i8[nb, D]; scale/radius: f32[nb] ->
    f32[B, nb]."""
    ue = ue.float()
    cent = centroids_q.float()
    dots = ue @ cent.T
    dots = dots * scale[None, :].float()
    unorm = torch.sqrt(torch.sum(ue * ue, dim=1, keepdim=True))
    return dots + unorm * radius[None, :].float()


def merge_topk(carry_s: torch.Tensor, carry_i: torch.Tensor,
               scores: torch.Tensor, ids: torch.Tensor, k: int):
    """First k of [carry | block] in (score desc, id asc) order.

    ``lax.top_k`` prefers lower positions on ties, the carry precedes the
    block and holds lower ids, so the reference's order is (score desc,
    id asc), with the carry's (-inf, -1) seeds first among -inf.
    ``torch.topk`` promises no tie order, so the order is made explicit:
    a stable sort by id, then a stable sort by score, descending."""
    cat_s = torch.cat([carry_s, scores], dim=1)
    cat_i = torch.cat([carry_i, ids], dim=1)
    by_id = torch.sort(cat_i, dim=1, stable=True).indices
    cat_s = torch.gather(cat_s, 1, by_id)
    cat_i = torch.gather(cat_i, 1, by_id)
    by_score = torch.sort(cat_s, dim=1, descending=True, stable=True).indices
    by_score = by_score[:, :k]
    return torch.gather(cat_s, 1, by_score), torch.gather(cat_i, 1, by_score)


def score_block(ue: torch.Tensor, ie_blk: torch.Tensor, block_ids: torch.Tensor,
                seen: torch.Tensor, seen_mask: torch.Tensor, start: int):
    """One item block's masked scores: ue @ blockᵀ, -0.0 -> +0.0, ids < 0
    (invalid) -> -inf, the users' seen ids in [start, start + blk) -> -inf
    (a scatter whose extra column absorbs out-of-block ids)."""
    b, blk = ue.shape[0], ie_blk.shape[0]
    scores = ue @ ie_blk.T
    # canonicalize -0.0 -> +0.0: one total order for ties
    scores = torch.where(scores == 0.0, 0.0, scores)
    scores = torch.where(block_ids[None, :] >= 0, scores, NEG_INF)
    pos = seen.long() - start
    in_block = seen_mask & (pos >= 0) & (pos < blk)
    cols = torch.where(in_block, pos, blk)
    rows = torch.arange(b, device=ue.device)[:, None].expand_as(cols)
    hit = torch.zeros((b, blk + 1), dtype=torch.bool, device=ue.device)
    hit[rows, cols] = True
    return torch.where(hit[:, :blk], NEG_INF, scores)


def fused_topk_score_ref(ue: torch.Tensor, table: torch.Tensor,
                         seen: torch.Tensor, seen_mask: torch.Tensor, *,
                         k: int, item_block: int, n_items: int):
    """Sweep over item blocks: score -> -0.0 canonicalization -> seen
    mask -> running top-K merge.  Returns (scores f32[B, k], ids i32[B, k])
    in (score desc, id asc) order; short slots are (-inf, -1)."""
    dev = ue.device
    b = ue.shape[0]
    blk = int(min(item_block, max(n_items, 1)))
    n_blocks = math.ceil(n_items / blk)
    tpad = n_blocks * blk - table.shape[0]
    if tpad > 0:
        table = torch.cat([table, table.new_zeros((tpad, table.shape[1]))])
    carry_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    carry_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    seen_mask = seen_mask.bool()
    for j in range(n_blocks):
        start = j * blk
        ids = start + torch.arange(blk, dtype=torch.int32, device=dev)
        block_ids = torch.where(ids < n_items, ids, -1)
        scores = score_block(ue.float(), table[start:start + blk].float(),
                             block_ids, seen, seen_mask, start)
        carry_s, carry_i = merge_topk(carry_s, carry_i, scores,
                                      ids.expand(b, blk), k)
    return carry_s, carry_i

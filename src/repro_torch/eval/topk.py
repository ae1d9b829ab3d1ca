"""Streaming top-K scorer — recommendation eval and serving without the
dense U×I score matrix (the port of ``repro/eval/topk.py``).

Users are scored in batches against item blocks:

  * user rows are gathered through ``kernels.ops.embedding_bag`` (bags of
    length 1 — the CUDA kernel on the card);
  * already-seen train items are masked through the user-CSR, padded per
    batch to the batch's largest degree (the reference pads to the
    largest degree among all queried users; both give the same result);
  * the fused route (the default whenever the item table lives on the
    device) runs one ``kernels.ops.fused_topk_score`` launch per user
    batch;
  * the block-major route (``fused=False``, and always for an item table
    demoted to the host store) stages every batch once, then gathers
    each item block once and merges it into every batch's running top-K
    with the plain PyTorch merge.

A table demoted by the planner arrives as a ``memory.HostResident``
facade (or its int8 arm, or a ``HotRowCache`` in front of either): its
user rows come from ``take`` and its item blocks from ``block``, with the
ids the reference passes (each user batch padded with user 0 to the batch
size; the last item block padded with item 0), so the facades' counters
equal the reference's.

A sharded sweep (``shard``, a ``pipeline.shard.ShardPlan`` with P > 1)
pads each user batch to a multiple of P; each rank stages and merges its
rows of every batch (block-major, as the reference's sharded sweep) and
the merged rows are all-gathered, so every rank returns the unsharded
sweep's ids and scores.

Tie-breaking contract (as the reference's): results are ordered by
(score desc, item id asc); scores equal to zero count as +0.0; slots
with fewer than K scoreable candidates return id -1 with score -inf.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device, to_device
from repro_torch.dist.collectives import all_gather_rows, rank_of
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as _ref
from repro_torch.memory.executor import HostResident

NEG_INF = float("-inf")
DEFAULT_USER_BATCH = 256
DEFAULT_ITEM_BLOCK = 1024


def _gather_rows(table: torch.Tensor, ids: torch.Tensor, impl):
    """Row gather through the kernel dispatch (bags of length 1): the
    caller's int32 or int64 ids as they are and no mask, so on the card
    one allocation and one launch."""
    return kops.embedding_bag(table, ids.reshape(-1, 1), None, "sum",
                              impl=impl)


def _padded_seen(user_ids: torch.Tensor, indptr: torch.Tensor,
                 items: torch.Tensor, pad_to: int):
    """Ragged CSR rows -> padded [n, pad_to] i32 ids + bool validity mask,
    built on the tensors' device."""
    n = user_ids.shape[0]
    dev = indptr.device
    if pad_to == 0 or items.numel() == 0:
        return (torch.zeros((n, 0), dtype=torch.int32, device=dev),
                torch.zeros((n, 0), dtype=torch.bool, device=dev))
    user_ids = user_ids.long()
    start = indptr[user_ids]
    deg = indptr[user_ids + 1] - start
    col = torch.arange(pad_to, device=dev)[None, :]
    mask = col < deg[:, None]
    idx = torch.clamp(start[:, None] + col, max=items.numel() - 1)
    padded = torch.where(mask, items[idx], 0).to(torch.int32)
    return padded.contiguous(), mask.contiguous()


def validate_user_ids(user_ids: np.ndarray, n_users: int) -> None:
    """Reject out-of-range ids at the serving boundary: a device gather
    would read another user's row (or fault) instead of raising."""
    if len(user_ids) == 0:
        return
    lo, hi = int(user_ids.min()), int(user_ids.max())
    if lo < 0 or hi >= n_users:
        bad = hi if hi >= n_users else lo
        raise ValueError(
            f"user_ids out of range: id {bad} not in [0, {n_users}); "
            "out-of-range ids are rejected uniformly regardless of "
            "embedding-table placement")


@torch.inference_mode()
def streaming_topk(user_e, item_e, k: int, *, user_ids=None,
                   seen_indptr=None, seen_items=None,
                   user_batch: int = DEFAULT_USER_BATCH,
                   item_block: int = DEFAULT_ITEM_BLOCK,
                   impl: str | None = None, fused: bool | None = None,
                   device=None, shard=None):
    """Top-K items per user without materializing the U×I score matrix.

    user_e, item_e: [U, D] / [I, D] tensors (on one device), numpy arrays
      moved to ``device`` (default 'cuda'), or ``HostResident`` facades
      whose rows stream to their serving device.
    user_ids: which users to score (default: all rows of user_e).
    seen_indptr/seen_items: user-CSR of already-seen (train) items to
      exclude, by global user id (numpy or tensors).  None -> nothing
      excluded.
    fused: None -> the fused kernel whenever the item table is on the
      device and the sweep is unsharded, else the block-major sweep; True
      -> the fused kernel (a host-resident item table or a sharded sweep
      raises); False -> the block-major sweep.  All routes give the same
      result.
    shard: a ``ShardPlan``; with P > 1 each of its ranks (all calling
      together) merges its rows of each batch, and the results are
      all-gathered.
    Returns (scores f32[n, k], ids i32[n, k]) numpy arrays, ordered by
    (score desc, id asc); invalid slots are (-inf, -1).
    """
    user_host = user_e if isinstance(user_e, HostResident) else None
    item_host = item_e if isinstance(item_e, HostResident) else None
    if user_host is not None:
        dev = user_host.device
    elif isinstance(user_e, torch.Tensor):
        dev = user_e.device
    elif item_host is not None:
        dev = item_host.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    if user_host is None:
        user_e = to_device(user_e, dev, torch.float32).contiguous()
    if item_host is None:
        item_e = to_device(item_e, dev, torch.float32).contiguous()
    n_items = int(item_e.shape[0])
    n_users = int(user_e.shape[0])
    if user_ids is None:
        user_ids = np.arange(n_users, dtype=np.int32)
    user_ids = np.asarray(user_ids, np.int32)
    validate_user_ids(user_ids, n_users)
    n_q = len(user_ids)
    k = int(k)
    sharded = shard is not None and shard.is_sharded
    fused_ok = item_host is None and not sharded
    if fused and not fused_ok:
        raise ValueError(
            "fused=True needs a device-resident item table and an "
            "unsharded sweep (a host-demoted table streams block-major; a "
            "sharded sweep merges per slice)")
    use_fused = fused_ok if fused is None else bool(fused)
    if n_q == 0 or n_items == 0:
        return (np.full((n_q, k), NEG_INF, np.float32),
                np.full((n_q, k), -1, np.int32))
    ub = int(min(user_batch, n_q))
    group, rank, slab = None, 0, ub
    if sharded:
        ub = math.ceil(ub / shard.n_shards) * shard.n_shards
        group = shard.process_group(dev)
        rank, slab = rank_of(group), ub // shard.n_shards
    blk = int(min(item_block, n_items))
    n_blocks = math.ceil(n_items / blk)
    if seen_indptr is not None:
        seen_indptr = to_device(seen_indptr, dev, torch.int64)
        seen_items = to_device(seen_items, dev, torch.int64)
    users = torch.from_numpy(user_ids).to(dev)

    def stage_batch(lo):
        sel = users[lo:lo + ub]
        if sharded:
            # this rank's rows of the batch padded with user 0, as the
            # reference's sharded batch
            sel = F.pad(sel, (0, ub - len(sel)))[rank * slab:
                                                 (rank + 1) * slab]
        if user_host is not None:
            # the reference gathers the batch padded with user 0
            sel_np = user_ids[lo:lo + ub]
            ue = user_host.take(np.pad(sel_np, (0, ub - len(sel_np))))
            ue = ue[rank * slab:(rank + 1) * slab] if sharded \
                else ue[:len(sel_np)]
        else:
            ue = _gather_rows(user_e, sel, impl)
        if seen_indptr is not None:
            deg = seen_indptr[sel.long() + 1] - seen_indptr[sel.long()]
            seen, smask = _padded_seen(sel, seen_indptr, seen_items,
                                       int(deg.max()))
        else:
            seen = torch.zeros((len(sel), 0), dtype=torch.int32, device=dev)
            smask = torch.zeros((len(sel), 0), dtype=torch.bool, device=dev)
        return ue, seen, smask

    tops = []
    if use_fused:
        # one kernel launch per user batch; the item table stays resident
        for lo in range(0, n_q, ub):
            ue, seen, smask = stage_batch(lo)
            tops.append(kops.fused_topk_score(
                ue, item_e, seen, smask, k=k, n_items=n_items,
                item_block=blk, impl=impl))
    else:
        # block-major sweep: stage every user batch once, then gather each
        # item block exactly once and fold it into every batch's carry
        batches = []
        for lo in range(0, n_q, ub):
            ue, seen, smask = stage_batch(lo)
            b = ue.shape[0]
            batches.append([ue, seen, smask,
                            torch.full((b, k), NEG_INF, device=dev),
                            torch.full((b, k), -1, dtype=torch.int32,
                                       device=dev)])
        for b0 in range(0, n_blocks * blk, blk):
            ids = np.arange(b0, b0 + blk)
            valid = ids < n_items
            block_ids = torch.from_numpy(
                np.where(valid, ids, -1).astype(np.int32)).to(dev)
            safe = np.where(valid, ids, 0)
            ie_blk = item_host.block(safe) if item_host is not None \
                else _gather_rows(item_e, torch.from_numpy(safe).to(dev), impl)
            for bt in batches:
                scores = _ref.score_block(bt[0], ie_blk, block_ids, bt[1],
                                          bt[2], b0)
                bt[3], bt[4] = _ref.merge_topk(
                    bt[3], bt[4], scores,
                    block_ids.expand(bt[0].shape[0], blk), k)
        tops = [(bt[3], bt[4]) for bt in batches]
    out_s = torch.cat([s for s, _ in tops])
    out_i = torch.cat([i for _, i in tops])
    if sharded:
        # [P * batches * slab, k] in rank order -> batch order; only the
        # last batch has padding rows, so the first n_q rows are the users'
        p, nb = shard.n_shards, len(tops)

        def unshard(t):
            t = all_gather_rows(t, group).reshape(p, nb, slab, k)
            return t.transpose(0, 1).reshape(nb * ub, k)[:n_q]

        out_s, out_i = unshard(out_s), unshard(out_i)
    return out_s.cpu().numpy(), out_i.cpu().numpy()

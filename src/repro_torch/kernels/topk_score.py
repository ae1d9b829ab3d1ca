"""Fused score + seen-mask + top-K — the wrapper of ``csrc/topk_score.cu``.

Replaces ``src/repro/kernels/topk_score.py:fused_topk_score_pallas``: one
launch per user batch of ``eval/topk.py``'s fused route.

Bound on the H100: operations — 2·B·I·D fp32 FLOPs on CUDA cores (the
dots are fp32 FMA, never TF32, so scores keep the reference's precision).
The kernel computes tiles of ``USER_TILE`` users × ``ITEM_TILE`` items as
a register-blocked product (8 × 4 scores a thread), with the rows copied
into a ring of shared buffers by ``cp.async`` under the FMAs; it splits
the catalogue over enough blocks to fill the card (``split_plan``) and
keeps a per-user top-K under an explicit (score desc, id asc)
comparison, offering only the scores that beat the user's current K-th
entry.  The lists sit in shared memory while they fit and in the
``[splits, B, k]`` scratch beyond, so every k is taken.  A second pass
merges the splits' lists.  Seen ids become a bit row per user first, so
masking costs O(1) per score.  The result does not depend on
``item_block`` or on the kernel's own tiling.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

USER_TILE = 64           # csrc/topk_score.cu kUserTile
ITEM_TILE = 128          # csrc/topk_score.cu kItemTile
# a group of 32 candidates with more than SORT_AT survivors goes into a
# user's list by one sort and merge (csrc/topk_score.cu kSortAt)
SORT_AT = 6
# shared memory of the partial kernel (csrc/topk_score.cu): the cp.async
# ring (kRingBytes), the fill counts (kFillBytes), and the lists while they
# fit under the block limit (kSmemLimit); an SM holds SM_SMEM bytes and
# reserves BLOCK_RESERVED per block, and runs at most 2 blocks
# (__launch_bounds__)
RING_BYTES, FILL_BYTES, SMEM_LIMIT = 82_944, 256, 232_448
SM_SMEM, BLOCK_RESERVED, MAX_BLOCKS_PER_SM = 233_472, 1_024, 2
NEG_INF = float("-inf")


def fused_topk_score_cuda(ue: torch.Tensor, table: torch.Tensor,
                          seen: torch.Tensor, seen_mask: torch.Tensor, *,
                          k: int, n_items: int, item_block: int = 1024):
    """ue: f32[B, D]; table: f32[R, D]; seen/seen_mask: i32/bool[B, L]
    padded seen ids -> (scores f32[B, k], ids i32[B, k]).  ``item_block``
    is accepted for the reference's signature; the result is the same for
    every value, so the kernel picks its own tile."""
    del item_block
    k = int(k)
    if k < 0:
        raise ValueError(f"k must be >= 0, got k={k}")
    if not ue.is_cuda:
        raise ValueError("fused_topk_score_cuda needs CUDA tensors")
    for name, t in (("ue", ue), ("table", table)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 2-D tensor")
    if table.shape[1] != ue.shape[1]:
        raise ValueError("ue and table must have the same width")
    b, d = ue.shape
    if seen.dtype != torch.int32 or seen.dim() != 2 or seen.shape[0] != b \
            or not seen.is_contiguous():
        raise ValueError("seen must be a contiguous int32 [B, L] tensor")
    if seen_mask.dtype != torch.bool or seen_mask.shape != seen.shape \
            or not seen_mask.is_contiguous():
        raise ValueError("seen_mask must be a contiguous bool tensor shaped "
                         "like seen")
    for t in (table, seen, seen_mask):
        if t.device != ue.device:
            raise ValueError("all inputs must share a device")
    dev = ue.device
    if b == 0 or k == 0 or n_items <= 0:
        return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev))
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    splits, tiles_per_split = split_plan(
        b, n_items, k,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if splits > 1:
        part_s = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    else:
        part_s, part_i = out_s, out_i
    bits = torch.empty((b, math.ceil(n_items / 32)), dtype=torch.int32,
                       device=dev)
    seen_len = seen.shape[1]
    vec4 = d % 4 == 0 and ue.data_ptr() % 16 == 0 \
        and table.data_ptr() % 16 == 0
    err = _build.entry("topk_score", "fused_topk_score_f32")(
        ue.data_ptr(), table.data_ptr(),
        seen.data_ptr() if seen_len else None,
        seen_mask.data_ptr() if seen_len else None,
        out_s.data_ptr(), out_i.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), bits.data_ptr(), b, d, table.shape[0], n_items,
        seen_len, k, tiles_per_split, splits, int(vec4),
        *_build.stream_of(ue))
    if err:
        _build.check(_build.load("topk_score"), err, "fused_topk_score")
    fused_topk_score_cuda.launches += 1
    return out_s, out_i


fused_topk_score_cuda.launches = 0


def blocks_per_sm(k: int) -> int:
    """Partial-kernel blocks one SM holds at list length ``k``."""
    smem = RING_BYTES + FILL_BYTES
    lists = 8 * USER_TILE * k
    if smem + lists <= SMEM_LIMIT:
        smem += lists
    return max(1, min(MAX_BLOCKS_PER_SM,
                      SM_SMEM // (smem + BLOCK_RESERVED)))


def split_plan(n_users: int, n_items: int, k: int,
               sms: int) -> tuple[int, int]:
    """(splits, item tiles per split) of the partial kernel: enough splits
    of the catalogue that the user tiles × splits fill the card for one
    wave (``blocks_per_sm(k)`` blocks on each of ``sms`` SMs), each split at
    least one tile, and no split empty."""
    n_tiles = math.ceil(n_items / ITEM_TILE)
    user_tiles = math.ceil(n_users / USER_TILE)
    splits = max(1, min(n_tiles, 65_535,
                        math.ceil(blocks_per_sm(k) * sms / user_tiles)))
    tiles_per_split = math.ceil(n_tiles / splits)
    return math.ceil(n_tiles / tiles_per_split), tiles_per_split

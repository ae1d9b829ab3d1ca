"""Fused score + seen-mask + top-K — the wrapper of ``csrc/topk_score.cu``.

Replaces ``src/repro/kernels/topk_score.py:fused_topk_score_pallas``: one
launch per user batch of ``eval/topk.py``'s fused route.

Bound on the H100: operations — 2·B·I·D fp32 FLOPs on CUDA cores (the
dots are fp32 FMA, never TF32, so scores keep the reference's precision).
The kernel streams 64-row item tiles through shared memory for tiles of
16 users, splits the catalogue over enough blocks to fill the card, keeps
a per-user top-K in shared memory under an explicit (score desc, id asc)
comparison, and merges the splits' lists in a second pass.  Seen ids
become a bit row per user first, so masking costs O(1) per score.  The
result does not depend on ``item_block`` or on the kernel's own tiling.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

MAX_K = 256              # csrc/topk_score.cu kMaxK
USER_TILE = 16           # csrc/topk_score.cu kUserTile
ITEM_TILE = 64           # csrc/topk_score.cu kItemTile
SMEM_LIMIT = 232_448     # bytes of shared memory one Hopper block may use
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
    if not 0 <= k <= MAX_K:
        raise ValueError(f"fused_topk_score_cuda supports 0 <= k <= {MAX_K}, "
                         f"got k={k}")
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
    lib = _build.load("topk_score")
    smem = lib.fused_topk_score_smem(d, k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"width D={d} with k={k} needs {smem} bytes of "
                         f"shared memory, over the block limit {SMEM_LIMIT}")
    n_tiles = math.ceil(n_items / ITEM_TILE)
    user_tiles = math.ceil(b / USER_TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(n_tiles, 65_535, math.ceil(2 * sms / user_tiles)))
    tiles_per_split = math.ceil(n_tiles / splits)
    splits = math.ceil(n_tiles / tiles_per_split)
    if splits > 1:
        part_s = torch.empty((splits, b, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, b, k), dtype=torch.int32, device=dev)
    else:
        part_s, part_i = out_s, out_i
    bits = torch.empty((b, math.ceil(n_items / 32)), dtype=torch.int32,
                       device=dev)
    seen_len = seen.shape[1]
    err = lib.fused_topk_score_f32(
        ue.data_ptr(), table.data_ptr(),
        seen.data_ptr() if seen_len else None,
        seen_mask.data_ptr() if seen_len else None,
        out_s.data_ptr(), out_i.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), bits.data_ptr(), b, d, table.shape[0], n_items,
        seen_len, k, tiles_per_split, splits, dev.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "fused_topk_score")
    fused_topk_score_cuda.launches += 1
    return out_s, out_i


fused_topk_score_cuda.launches = 0

"""Embedding bag — the wrapper of ``csrc/embedding_bag.cu``.

Replaces ``src/repro/kernels/embedding_bag.py:embedding_bag_pallas``.  On
the serving path it is the user-row gather of ``eval/topk.py`` (bags of
length 1) and the item-block gather of the block-major sweep.

Bound on the H100: memory — B·L·D·4 bytes of rows read and B·D·4
written.  One warp owns one bag and keeps its D floats in registers as
16-byte float4 lanes; masked slots are never read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor, combiner: str = "sum") -> torch.Tensor:
    """table: f32[V, D]; ids: i32[B, L]; mask: bool[B, L] -> f32[B, D].
    Live ids must lie in [0, V) (the callers validate them)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(combiner)
    if not table.is_cuda:
        raise ValueError("embedding_bag_cuda needs CUDA tensors")
    if table.dtype != torch.float32 or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous float32 [V, D] tensor")
    if ids.dtype != torch.int32 or ids.dim() != 2 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int32 [B, L] tensor")
    if mask.dtype != torch.bool or mask.shape != ids.shape \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous bool tensor shaped like ids")
    if ids.device != table.device or mask.device != table.device:
        raise ValueError("table, ids and mask must share a device")
    b, bag_len = ids.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    if bag_len == 0:
        return out.zero_()
    vec4 = d % 4 == 0 and table.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    lib = _build.load("embedding_bag")
    err = lib.embedding_bag_f32(table.data_ptr(), ids.data_ptr(),
                                mask.data_ptr(), out.data_ptr(), b, bag_len,
                                d, int(combiner == "mean"), int(vec4),
                                table.device.index or 0,
                                ctypes.c_void_p(torch.cuda.current_stream(
                                    table.device).cuda_stream))
    _build.check(lib, err, "embedding_bag")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0

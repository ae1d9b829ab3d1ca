"""Embedding bag — the wrapper of ``csrc/embedding_bag.cu``.

Replaces ``src/repro/kernels/embedding_bag.py:embedding_bag_pallas``.  On
the serving path it is the user-row gather of ``eval/topk.py`` (bags of
length 1) and the item-block gather of the block-major sweep.

Bound on the H100: memory — B·L·D·4 bytes of rows read and B·D·4
written.  One warp owns one bag and keeps its D floats in registers as
16-byte float4 lanes; masked slots are never read.  At the serving shape
(B = 256, L = 1) the device time is a launch, so the wrapper's host path
is kept short: ids go in as int32 or int64 as the caller holds them, a
``None`` mask means every slot is live (no mask to build), and the launch
takes the raw stream handle and a cached C function (``_build.stream_of``,
``_build.entry``).  ``noop_cuda`` launches an empty kernel through the
same path, to measure the launch floor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

ID_DTYPES = (torch.int32, torch.int64)


def check_inputs(table: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take."""
    if not table.is_cuda or table.dtype is not torch.float32 \
            or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous float32 [V, D] CUDA "
                         "tensor")
    if ids.dtype not in ID_DTYPES or ids.dim() != 2 \
            or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int32 or int64 [B, L] "
                         "tensor")
    device = table.get_device()
    if ids.get_device() != device:
        raise ValueError("table and ids must share a device")
    if mask is not None and (mask.dtype is not torch.bool
                             or mask.shape != ids.shape
                             or not mask.is_contiguous()
                             or mask.get_device() != device):
        raise ValueError("mask must be None or a contiguous bool tensor "
                         "shaped like ids, on their device")


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor | None,
                       combiner: str = "sum") -> torch.Tensor:
    """table: f32[V, D]; ids: i32 or i64[B, L]; mask: bool[B, L], or None
    for every slot live -> f32[B, D].  Live ids must lie in [0, V) (the
    callers validate them)."""
    if combiner != "sum" and combiner != "mean":
        raise ValueError(combiner)
    check_inputs(table, ids, mask)
    b, bag_len = ids.shape
    d = table.shape[1]
    out = table.new_empty((b, d))
    if b == 0 or d == 0:
        return out
    if bag_len == 0:
        return out.zero_()
    t_ptr, o_ptr = table.data_ptr(), out.data_ptr()
    vec4 = d % 4 == 0 and t_ptr % 16 == 0 and o_ptr % 16 == 0
    device, stream = _build.stream_of(table)
    err = _build.entry("embedding_bag", "embedding_bag_f32")(
        t_ptr, ids.data_ptr(), None if mask is None else mask.data_ptr(),
        o_ptr, b, bag_len, d, int(combiner == "mean"), int(vec4),
        int(ids.dtype is torch.int64), device, stream)
    if err:
        _build.check(_build.load("embedding_bag"), err, "embedding_bag")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0


def noop_cuda(like: torch.Tensor) -> None:
    """Launch one empty kernel on ``like``'s device and current stream,
    through the wrapper's launch path (the launch floor); not counted as a
    launch of any kernel."""
    device, stream = _build.stream_of(like)
    err = _build.entry("embedding_bag", "repro_noop")(device, stream)
    if err:
        _build.check(_build.load("embedding_bag"), err, "repro_noop")

"""CSR SpMM — the wrapper of ``csrc/spmm_csr.cu`` and the host CSR build.

Replaces ``src/repro/kernels/spmm.py:spmm_csr_pallas``.  It carries every
LightGCN aggregation: both directions of ``sym_propagate``, every layer.

Bound on the H100: memory.  A call reads each source row once per edge
(E·D·4 bytes of gathers), E·4 bytes of indices, and writes n·D·4 bytes;
one add per gathered float.  The design keeps the destination row in
registers of the one warp that owns it (no atomics, no shared memory),
reads rows as 16-byte float4 lanes, and unrolls the edge loop so several
row loads are in flight per warp.  Its weak spot is the Zipf degree tail:
the longest row is walked by a single warp.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build


def spmm_csr_cuda(reduce: str, values: torch.Tensor, indptr: torch.Tensor,
                  src_sorted: torch.Tensor, n_nodes: int,
                  gather: bool = False) -> torch.Tensor:
    """values: f32[N_src, D] (gather) or f32[E, D]; indptr: i64[n_nodes+1];
    src_sorted: i32[E] (read iff gather) -> f32[n_nodes, D]."""
    if reduce not in ("sum", "max"):
        raise ValueError(reduce)
    if not values.is_cuda:
        raise ValueError("spmm_csr_cuda needs CUDA tensors")
    if values.dtype != torch.float32 or values.dim() != 2 \
            or not values.is_contiguous():
        raise ValueError("values must be a contiguous float32 [rows, D] tensor")
    if indptr.dtype != torch.int64 or indptr.dim() != 1 \
            or not indptr.is_contiguous() or indptr.numel() < n_nodes + 1:
        raise ValueError("indptr must be a contiguous int64 [n_nodes + 1] tensor")
    if gather and (src_sorted.dtype != torch.int32 or src_sorted.dim() != 1
                   or not src_sorted.is_contiguous()):
        raise ValueError("src_sorted must be a contiguous int32 [E] tensor")
    for t in (indptr, src_sorted):
        if t.device != values.device:
            raise ValueError("values, indptr and src_sorted must share a device")
    d = values.shape[1]
    out = torch.empty((n_nodes, d), dtype=torch.float32, device=values.device)
    if n_nodes == 0 or d == 0:
        return out
    vec4 = d % 4 == 0 and values.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    lib = _build.load("spmm_csr")
    err = lib.spmm_csr_f32(values.data_ptr(), indptr.data_ptr(),
                           src_sorted.data_ptr() if gather else None,
                           out.data_ptr(), n_nodes, d, int(gather),
                           int(reduce == "max"), int(vec4),
                           values.device.index or 0,
                           ctypes.c_void_p(torch.cuda.current_stream(
                               values.device).cuda_stream))
    _build.check(lib, err, "spmm_csr")
    spmm_csr_cuda.launches += 1
    return out


spmm_csr_cuda.launches = 0


def build_csr_by_dst(dst: np.ndarray, src: np.ndarray, n_nodes: int,
                     edge_mask: np.ndarray | None = None):
    """Host-side helper: sort edges by dst, build indptr.  Masked (padded)
    edges are dropped.  Returns (indptr i32, src_sorted i32, perm), equal
    byte for byte to the reference's."""
    dst = np.asarray(dst)
    src = np.asarray(src)
    if edge_mask is not None:
        keep = np.asarray(edge_mask).astype(bool)
        dst, src = dst[keep], src[keep]
        perm_base = np.nonzero(keep)[0]
    else:
        perm_base = np.arange(len(dst))
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n_nodes + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(np.bincount(dst, minlength=n_nodes))
    return indptr, src[order].astype(np.int32), perm_base[order]

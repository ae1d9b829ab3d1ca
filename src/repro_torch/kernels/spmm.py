"""CSR SpMM — the wrapper of ``csrc/spmm_csr.cu`` and the host CSR build.

Replaces ``src/repro/kernels/spmm.py:spmm_csr_pallas``.  It carries every
LightGCN aggregation (both directions of ``sym_propagate``, every layer,
and through the reverse CSR every backward) and NGCF's composed edge
aggregation.

Bound on the H100: memory.  A call reads each source row once per edge
(E·D·4 bytes of gathers), E·4 bytes of indices, and writes n·D·4 bytes;
one add per gathered float.  The kernel splits the edges, not the rows:
a merge-path partition (``row_split.py``, ``csrc/row_split.cuh``) cuts
rows + edges into chunks of ``CHUNK`` items and one warp walks each, so
a Zipf row of 256k edges is spread over ~250 warps instead of one.  Rows
that end inside a chunk are reduced in registers (16-byte float4 lanes,
several row loads in flight) and written directly; a row that crosses a
chunk boundary leaves one partial per chunk in a workspace, and a second
small pass combines them in chunk order.  No atomics, so the output is
the same bits on every call; no host read per call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, row_split

# merge items (edges + row ends) per chunk, one warp each: ~15,000 chunks
# per direction on the 15.08M-edge graph, ~3.5 waves of resident warps
CHUNK = 1024


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
    n_edges = src_sorted.shape[0] if gather else values.shape[0]
    rows = row_split.chunk_rows(indptr, n_nodes, n_edges, CHUNK)
    n_chunks = rows.numel() - 1
    partial = torch.empty((n_chunks, 2, d), dtype=torch.float32,
                          device=values.device)
    vec4 = d % 4 == 0 and values.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    err = _build.entry("spmm_csr", "spmm_csr_f32")(
        values.data_ptr(), indptr.data_ptr(),
        src_sorted.data_ptr() if gather else None, rows.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n_nodes, n_chunks, CHUNK, d,
        int(gather), int(reduce == "max"), int(vec4),
        *_build.stream_of(values))
    if err:
        _build.check(_build.load("spmm_csr"), err, "spmm_csr")
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

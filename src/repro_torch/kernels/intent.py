"""DGCF's two routing kernels — the wrappers of ``csrc/intent_spmm.cu`` and
``csrc/intent_sddmm.cu``.

Disentangled Graph Collaborative Filtering (DGCF) splits each embedding
into K intent chunks of D/K columns and gives every edge one weight per
intent, which the step itself recomputes; so its aggregation is weighted
per edge and per chunk, and its routing scores every edge in every chunk:

  * ``intent_spmm_cuda``:  out[v, chunk k] = sum_e w[e, k] · x[src_e, chunk k]
    over v's CSR edges;
  * ``intent_sddmm_cuda``: s[e, k] = <a[row_e, chunk k], b[src_e, chunk k]>
    for every CSR edge.

Each is the other's backward (``pipeline/sparse.py``), so DGCF's forward
and backward run on these two, the existing ``spmm_csr`` for its degrees,
and elementwise work on [E, K] and [N, D] tensors: no [E, D] matrix.

Bound on the H100: memory.  A call gathers one source row per edge
(E·D·4 bytes, mostly L2 hits), reads E·4 bytes of indices and moves the
E·K·4 bytes of weights or dots.  Both split the edges, not the rows, by
the merge-path partition of ``spmm_csr`` (``row_split.py``,
``csrc/row_split.cuh``): chunks of ``CHUNK`` merge items, one warp each.
No atomics, so each output is the same bits on every call; no host read
per call.  The plain versions are ``ref.intent_spmm_ref`` and
``ref.intent_sddmm_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, row_split

# merge items (edges + row ends) per chunk, one warp each
CHUNK = 1024


def _check_csr(x: torch.Tensor, indptr: torch.Tensor, src: torch.Tensor,
               n_rows: int, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors")
    if indptr.dtype != torch.int64 or indptr.dim() != 1 \
            or not indptr.is_contiguous() or indptr.numel() < n_rows + 1:
        raise ValueError("indptr must be a contiguous int64 [n_rows + 1] "
                         "tensor")
    if src.dtype != torch.int32 or src.dim() != 1 or not src.is_contiguous():
        raise ValueError("src must be a contiguous int32 [E] tensor")


def _check_table(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 [rows, D] "
                         "tensor")


def _same_device(ref: torch.Tensor, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device != ref.device:
            raise ValueError("every operand of an intent kernel must share "
                             "a device")


def intent_spmm_cuda(w: torch.Tensor, x: torch.Tensor, indptr: torch.Tensor,
                     src: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """w: f32[E, K]; x: f32[N_src, D] (K divides D); indptr:
    i64[n_nodes+1]; src: i32[E] -> f32[n_nodes, D]."""
    _check_csr(x, indptr, src, n_nodes, "intent_spmm_cuda")
    _check_table(x, "x")
    _check_table(w, "w")
    _same_device(x, w, indptr, src)
    e, k = w.shape
    d = x.shape[1]
    if e != src.numel():
        raise ValueError("w must hold one row per edge")
    if k == 0 or d % k:
        raise ValueError(f"K = {k} intents must divide D = {d}")
    out = torch.empty((n_nodes, d), dtype=torch.float32, device=x.device)
    if n_nodes == 0 or d == 0:
        return out
    if e == 0:
        return out.zero_()
    rows = row_split.chunk_rows(indptr, n_nodes, e, CHUNK)
    n_chunks = rows.numel() - 1
    partial = torch.empty((n_chunks, 2, d), dtype=torch.float32,
                          device=x.device)
    vec4 = (d // k) % 4 == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    err = _build.entry("intent_spmm", "intent_spmm_f32")(
        x.data_ptr(), w.data_ptr(), indptr.data_ptr(), src.data_ptr(),
        rows.data_ptr(), partial.data_ptr(), out.data_ptr(), n_nodes,
        n_chunks, CHUNK, d, k, int(vec4), *_build.stream_of(x))
    if err:
        _build.check(_build.load("intent_spmm"), err, "intent_spmm")
    intent_spmm_cuda.launches += 1
    return out


intent_spmm_cuda.launches = 0


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def intent_sddmm_cuda(a: torch.Tensor, b: torch.Tensor, indptr: torch.Tensor,
                      src: torch.Tensor, n_factors: int) -> torch.Tensor:
    """a: f32[n_rows, D]; b: f32[N_src, D]; indptr: i64[n_rows+1] with
    indptr[n_rows] = E; src: i32[E] -> f32[E, n_factors].  The kernel
    takes an edge on D / 4 float4 lanes (D / (4K) a power of two) or D
    float lanes (D / K a power of two), at most 32: D up to 128."""
    n_rows = indptr.numel() - 1
    _check_csr(a, indptr, src, n_rows, "intent_sddmm_cuda")
    _check_table(a, "a")
    _check_table(b, "b")
    _same_device(a, b, indptr, src)
    d, k = a.shape[1], int(n_factors)
    if b.shape[1] != d:
        raise ValueError("a and b must have the same width D")
    if a.shape[0] < n_rows:
        raise ValueError("a must hold a row per CSR row")
    if k <= 0 or d % k:
        raise ValueError(f"K = {k} intents must divide D = {d}")
    vec4 = (d // k) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (a, b))
    lanes = d // 4 if vec4 else d
    if lanes > 32 or not _pow2(lanes) or not _pow2(lanes // k):
        raise ValueError(f"intent_sddmm's kernel takes D up to 128 with "
                         f"D / K a power of two; got D = {d}, K = {k}")
    e = src.numel()
    out = torch.empty((e, k), dtype=torch.float32, device=a.device)
    if e == 0 or n_rows == 0:
        return out
    rows = row_split.chunk_rows(indptr, n_rows, e, CHUNK)
    n_chunks = rows.numel() - 1
    err = _build.entry("intent_sddmm", "intent_sddmm_f32")(
        a.data_ptr(), b.data_ptr(), indptr.data_ptr(), src.data_ptr(),
        rows.data_ptr(), out.data_ptr(), n_rows, n_chunks, CHUNK, d, k,
        int(vec4), *_build.stream_of(a))
    if err:
        _build.check(_build.load("intent_sddmm"), err, "intent_sddmm")
    intent_sddmm_cuda.launches += 1
    return out


intent_sddmm_cuda.launches = 0

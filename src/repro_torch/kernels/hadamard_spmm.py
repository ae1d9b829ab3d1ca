"""Fused gather-Hadamard-aggregate — the wrapper of ``csrc/hadamard_spmm.cu``
and the plain structured routes.

Replaces ``src/repro/kernels/hadamard_spmm.py:hadamard_spmm_pallas``.  It
carries NGCF's per-layer Hadamard messages without the [E, D] matrix:
two calls per layer forward (``hadamard_agg_item``/``_user``) and four in
the rematerialising backward (``pipeline/sparse.py``).

Bound on the H100: memory.  A call reads two source rows per edge
(2·E·D·4 bytes of gathers), 2·E·4 bytes of indices, and writes n·D·4
bytes; one multiply and one add per gathered pair.  Where ``x_idx`` and
``y_idx`` are one tensor (NGCF's ``d_x``), a product kernel first forms
p = x * y over the rows both tables hold, in a workspace of at most one
[rows, D] table, and the chunk kernel gathers one row of p per edge
(E·D·4 bytes of gathers, E·4 of indices).  The kernel splits
the edges, not the rows, as ``spmm_csr.cu`` does: a merge-path partition
(``row_split.py``, ``csrc/row_split.cuh``) cuts rows + edges into chunks
of ``CHUNK`` items and one warp walks each, so the 256k-edge item row is
spread over ~250 warps.  Rows that end inside a chunk are summed in
registers and written with the (scale, leaky-relu) epilogue; a row that
crosses a chunk boundary leaves pre-epilogue partials in a workspace,
and a second small pass sums them in chunk order and applies the
epilogue once.  No atomics, so the output is the same bits on every
call; no host read per call.

``hadamard_spmm_plain`` is the port of ``hadamard_spmm_xla``: given a
caller-asserted ``structure`` on the index vectors, the Hadamard factors
out of the aggregation and no [E, D] product is formed —

  * ``y_is_dst``  (y_idx_e == dst_e):     out = y * spmm(gather x)
  * ``x_eq_y``    (x_idx_e == y_idx_e):   out = spmm(gather (x * y))
  * ``general``:  the naive gather/product/scatter (``ref``).

The CUDA route takes no ``structure``: it observes the indices instead.
Index tensors with one ``data_ptr()`` (and, checked already, one length)
take the shared-index route above, which is ``x_eq_y``'s factoring done
bit for bit as the general form rounds it (each term the same rounded
product, added in the same order over the same chunks); any other pair,
``y_is_dst`` included, runs the general form, as the Pallas route does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, row_split
from repro_torch.kernels import ref as _ref

STRUCTURES = ("general", "y_is_dst", "x_eq_y")
# merge items (edges + row ends) per chunk, one warp each
CHUNK = 1024


def _check_index(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 [E] tensor")


def hadamard_spmm_cuda(x: torch.Tensor, y: torch.Tensor, indptr: torch.Tensor,
                       x_idx: torch.Tensor, y_idx: torch.Tensor, n_nodes: int,
                       scale: torch.Tensor | None = None,
                       slope: float | None = None) -> torch.Tensor:
    """x: f32[Nx, D], y: f32[Ny, D]; indptr: i64[n_nodes+1]; x_idx, y_idx:
    i32[E]; scale: f32[n_nodes] or None; slope: leaky-relu slope or None
    -> f32[n_nodes, D]."""
    if not x.is_cuda:
        raise ValueError("hadamard_spmm_cuda needs CUDA tensors")
    for t, name in ((x, "x"), (y, "y")):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [rows, D] "
                             "tensor")
    if y.shape[1] != x.shape[1]:
        raise ValueError("x and y must have the same width D")
    if indptr.dtype != torch.int64 or indptr.dim() != 1 \
            or not indptr.is_contiguous() or indptr.numel() < n_nodes + 1:
        raise ValueError("indptr must be a contiguous int64 [n_nodes + 1] tensor")
    _check_index(x_idx, "x_idx")
    _check_index(y_idx, "y_idx")
    if x_idx.numel() != y_idx.numel():
        raise ValueError("x_idx and y_idx must have one entry per edge")
    if scale is not None and (scale.dtype != torch.float32 or scale.dim() != 1
                              or not scale.is_contiguous()
                              or scale.numel() < n_nodes):
        raise ValueError("scale must be a contiguous float32 [n_nodes] tensor")
    for t in (y, indptr, x_idx, y_idx, scale):
        if t is not None and t.device != x.device:
            raise ValueError("every operand of hadamard_spmm must share a device")
    d = x.shape[1]
    out = torch.empty((n_nodes, d), dtype=torch.float32, device=x.device)
    if n_nodes == 0 or d == 0:
        return out
    if x_idx.numel() == 0:
        # no edges: every row aggregates to zero, and the epilogue maps
        # zero to zero (the reference returns zeros without a launch)
        return out.zero_()
    rows = row_split.chunk_rows(indptr, n_nodes, x_idx.numel(), CHUNK)
    n_chunks = rows.numel() - 1
    partial = torch.empty((n_chunks, 2, d), dtype=torch.float32,
                          device=x.device)
    epilogue = (scale.data_ptr() if scale is not None else None,
                int(slope is not None),
                float(slope) if slope is not None else 0.0)
    tail = (out.data_ptr(), n_nodes, n_chunks, CHUNK, d)
    if x_idx.data_ptr() == y_idx.data_ptr():
        # one index for both gathers: x * y once per shared row, then one
        # gathered row per edge
        n_shared = min(x.shape[0], y.shape[0])
        prod = torch.empty((n_shared, d), dtype=torch.float32,
                           device=x.device)
        vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, y, prod, out))
        err = _build.entry("hadamard_spmm", "hadamard_spmm_shared_f32")(
            x.data_ptr(), y.data_ptr(), n_shared, indptr.data_ptr(),
            x_idx.data_ptr(), rows.data_ptr(), prod.data_ptr(),
            partial.data_ptr(), *epilogue, *tail, int(vec4),
            *_build.stream_of(x))
        hadamard_spmm_cuda.shared_launches += 1
    else:
        vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, y, out))
        err = _build.entry("hadamard_spmm", "hadamard_spmm_f32")(
            x.data_ptr(), y.data_ptr(), indptr.data_ptr(), x_idx.data_ptr(),
            y_idx.data_ptr(), rows.data_ptr(), partial.data_ptr(),
            *epilogue, *tail, int(vec4), *_build.stream_of(x))
    if err:
        _build.check(_build.load("hadamard_spmm"), err, "hadamard_spmm")
    hadamard_spmm_cuda.launches += 1
    return out


hadamard_spmm_cuda.launches = 0
# the calls of ``launches`` that took the shared-index route
hadamard_spmm_cuda.shared_launches = 0


def _epilogue(out, scale, slope):
    if scale is not None:
        out = out * scale[:, None]
    if slope is not None:
        out = torch.where(out >= 0, out, out * slope)
    return out


def hadamard_spmm_plain(x: torch.Tensor, y: torch.Tensor, indptr: torch.Tensor,
                        x_idx: torch.Tensor, y_idx: torch.Tensor, n_nodes: int,
                        scale: torch.Tensor | None = None,
                        slope: float | None = None,
                        structure: str = "general") -> torch.Tensor:
    """The plain PyTorch route (``hadamard_spmm_xla``'s port): the
    structured forms factor the product out of the aggregation and form
    no [E, D] product; ``general`` is the naive ``hadamard_spmm_ref``."""
    if structure not in STRUCTURES:
        raise ValueError(f"structure must be one of {STRUCTURES}, "
                         f"got {structure!r}")
    if structure == "y_is_dst":
        # y rides the destination: out[v] = y[v] * sum_e x[x_idx_e]
        agg = _ref.spmm_csr_ref("sum", x.float(), indptr, x_idx, n_nodes,
                                gather=True)
        return _epilogue(y.float() * agg, scale, slope)
    if structure == "x_eq_y":
        # both gathers share an index: the product forms at node level
        prod = x.float() * y.float()
        agg = _ref.spmm_csr_ref("sum", prod, indptr, x_idx, n_nodes,
                                gather=True)
        return _epilogue(agg, scale, slope)
    return _ref.hadamard_spmm_ref(x, y, indptr, x_idx, y_idx, n_nodes,
                                  scale=scale, slope=slope)

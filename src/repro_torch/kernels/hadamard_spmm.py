"""Fused gather-Hadamard-aggregate — the wrapper of ``csrc/hadamard_spmm.cu``
and the plain structured routes.

Replaces ``src/repro/kernels/hadamard_spmm.py:hadamard_spmm_pallas``.  It
carries NGCF's per-layer Hadamard messages without the [E, D] matrix:
two calls per layer forward (``hadamard_agg_item``/``_user``) and four in
the rematerialising backward (``pipeline/sparse.py``).

Bound on the H100: memory.  A call reads two source rows per edge
(2·E·D·4 bytes of gathers), 2·E·4 bytes of indices, and writes n·D·4
bytes; one multiply and one add per gathered pair.  The kernel follows
``spmm_csr.cu``: a warp owns a destination row and keeps it in
registers, so the sum needs no atomics and runs in CSR order; the
(x_idx, y_idx) pairs are loaded 32 at a time and broadcast by shuffle.
Its weak spot is the same Zipf degree tail: the longest row is walked by
a single warp.

``hadamard_spmm_plain`` is the port of ``hadamard_spmm_xla``: given a
caller-asserted ``structure`` on the index vectors, the Hadamard factors
out of the aggregation and no [E, D] product is formed —

  * ``y_is_dst``  (y_idx_e == dst_e):     out = y * spmm(gather x)
  * ``x_eq_y``    (x_idx_e == y_idx_e):   out = spmm(gather (x * y))
  * ``general``:  the naive gather/product/scatter (``ref``).

The CUDA kernel needs no structure: it runs the general form on
``x_idx``/``y_idx`` whatever ``structure`` says, as the Pallas route does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

STRUCTURES = ("general", "y_is_dst", "x_eq_y")


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
    vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, y, out))
    lib = _build.load("hadamard_spmm")
    err = lib.hadamard_spmm_f32(
        x.data_ptr(), y.data_ptr(), indptr.data_ptr(), x_idx.data_ptr(),
        y_idx.data_ptr(), scale.data_ptr() if scale is not None else None,
        int(slope is not None), float(slope) if slope is not None else 0.0,
        out.data_ptr(), n_nodes, d, int(vec4), x.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "hadamard_spmm")
    hadamard_spmm_cuda.launches += 1
    return out


hadamard_spmm_cuda.launches = 0


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

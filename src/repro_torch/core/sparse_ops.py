"""Generalized SDDMM / SpMM on COO graphs (the port of
``repro/core/sparse_ops.py``).

The reference computes these with XLA gathers and ``segment_*``
reductions, outside any Pallas kernel; their counterparts here are
``index_select``, ``index_add`` and ``scatter_reduce``, differentiated by
torch autograd.  All edge-level ops respect ``edge_mask``.

  sddmm(op, x_src, x_dst, src, dst, mask)   -> m[E_pad, D] or [E_pad]
      'mul' x[src] * x[dst], 'dot' <x[src], x[dst]>, 'add', 'copy' x[src]
  spmm(reduce, msg, dst, n_nodes, mask)     -> h[n_nodes, D]
      reduce in {'sum', 'mean', 'max'}; 'max' maps every non-finite
      maximum to 0: empty rows, and rows whose maximum is +inf or NaN
  edge_softmax(scores, dst, n_nodes, mask)  -> softmax over incoming edges
  gspmm_copy_sum(x, src, dst, n, mask, c)   -> sum_e c_e * x[src_e] at dst
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import SDDMM_OPS, sddmm_ref

SPMM_REDUCE = ("sum", "mean", "max")


def sddmm(op: str, x_src: torch.Tensor, x_dst: torch.Tensor,
          src: torch.Tensor, dst: torch.Tensor,
          edge_mask: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense op at edge positions ('copy' takes no coeff)."""
    if op not in SDDMM_OPS:
        raise ValueError(f"unknown sddmm op {op}")
    return sddmm_ref(op, x_src, x_dst, src, dst, edge_mask)


class _SegmentSum(torch.autograd.Function):
    """``index_add`` whose backward is the gather ``g[index]`` alone: torch's
    own ``index_add`` derivative keeps its [E, D] source for autograd, which
    at 15M edges holds 7.7 GB per aggregation; the transpose of a segment
    sum needs only the index (as ``jax.ops.segment_sum``'s does)."""

    @staticmethod
    def forward(ctx, values, index, n):
        ctx.save_for_backward(index)
        out = values.new_zeros((n,) + tuple(values.shape[1:]))
        return out.index_add_(0, index, values)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return g.index_select(0, index), None, None


def segment_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """out[v] = sum of values[e] over index[e] == v, as
    ``jax.ops.segment_sum``."""
    return _SegmentSum.apply(values, index, n)


def spmm(reduce: str, msg: torch.Tensor, dst: torch.Tensor, n_nodes: int,
         edge_mask: torch.Tensor) -> torch.Tensor:
    """Segment-reduce messages onto destination nodes."""
    if reduce not in SPMM_REDUCE:
        raise ValueError(f"unknown spmm reduce {reduce}")
    mask = edge_mask if msg.dim() == 1 else edge_mask[:, None]
    if reduce == "max":
        m = torch.where(mask, msg, float("-inf"))
        out = msg.new_full((n_nodes,) + tuple(msg.shape[1:]), float("-inf"))
        index = dst.long().view((-1,) + (1,) * (msg.dim() - 1)).expand_as(m)
        out = out.scatter_reduce(0, index, m, "amax")
        return torch.where(torch.isfinite(out), out, 0.0)
    out = segment_sum(torch.where(mask, msg, 0.0), dst, n_nodes)
    if reduce == "mean":
        cnt = segment_sum(edge_mask.to(msg.dtype), dst, n_nodes)
        cnt = cnt.clamp_min(1)
        out = out / (cnt[:, None] if msg.dim() > 1 else cnt)
    return out


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 edge_mask: torch.Tensor) -> torch.Tensor:
    """Softmax over incoming edges per destination (GAT-style)."""
    s = torch.where(edge_mask, scores, float("-inf"))
    mx = scores.new_full((n_nodes,), float("-inf")).scatter_reduce(
        0, dst.long(), s, "amax")
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.where(edge_mask, torch.exp(s - mx.index_select(0, dst)), 0.0)
    z = segment_sum(e, dst, n_nodes)
    return e / z.clamp_min(1e-20).index_select(0, dst)


def gspmm_copy_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n_nodes: int, edge_mask: torch.Tensor,
                   coeff: torch.Tensor | None = None) -> torch.Tensor:
    """Fused gather-scale-scatter: sum_e coeff_e * x[src_e] -> dst
    (GCN's and LightGCN's message + aggregate as one SpMM, paper §9);
    coeff=None means an unweighted copy."""
    m = x.index_select(0, src)
    if coeff is not None:
        m = m * coeff[:, None]
    m = torch.where(edge_mask[:, None], m, 0.0)
    return segment_sum(m, dst, n_nodes)

"""Kernel dispatch with the reference's signatures.

``impl`` is None, 'torch' or 'cuda':
  * None routes by where the tensors lie: a CUDA tensor goes to the
    hand-written kernel, a CPU tensor to the plain PyTorch version;
  * 'torch' runs the plain version on either device;
  * 'cuda' runs the kernel and raises on a CPU tensor.
A kernel that fails to build or launch raises; nothing falls back.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.hadamard_spmm import (STRUCTURES, hadamard_spmm_cuda,
                                               hadamard_spmm_plain)
from repro_torch.kernels.spmm import spmm_csr_cuda
from repro_torch.kernels.topk_score import fused_topk_score_cuda

IMPLS = (None, "torch", "cuda")


def route(impl, tensor) -> str:
    """'cuda' or 'torch' for a call on ``tensor`` under ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl is None:
        return "cuda" if tensor.is_cuda else "torch"
    if impl == "cuda" and not tensor.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; this one lies on "
                         f"{tensor.device}")
    return impl


def spmm_csr(reduce, values, indptr, src_sorted, n_nodes, gather=False,
             impl=None):
    if route(impl, values) == "torch":
        return _ref.spmm_csr_ref(reduce, values, indptr, src_sorted, n_nodes,
                                 gather=gather)
    return spmm_csr_cuda(reduce, values, indptr, src_sorted, n_nodes,
                         gather=gather)


def hadamard_spmm(x, y, indptr, x_idx, y_idx, n_nodes, scale=None,
                  slope=None, structure="general", impl=None):
    """Fused gather-Hadamard-aggregate: out[v] = sum_{e: dst_e = v}
    x[x_idx_e] * y[y_idx_e] with an optional (scale, leaky-relu)
    epilogue.  ``structure`` is the caller-asserted index invariant the
    plain route factors by; the CUDA kernel runs the general form on
    ``x_idx``/``y_idx`` whatever it says."""
    if structure not in STRUCTURES:
        raise ValueError(f"structure must be one of {STRUCTURES}, "
                         f"got {structure!r}")
    if route(impl, x) == "torch":
        return hadamard_spmm_plain(x, y, indptr, x_idx, y_idx, n_nodes,
                                   scale=scale, slope=slope,
                                   structure=structure)
    return hadamard_spmm_cuda(x, y, indptr, x_idx, y_idx, n_nodes,
                              scale=scale, slope=slope)


def embedding_bag(table, ids, mask, combiner="sum", impl=None):
    if route(impl, table) == "torch":
        return _ref.embedding_bag_ref(table, ids, mask, combiner)
    return embedding_bag_cuda(table, ids, mask, combiner)


def fused_topk_score(ue, table, seen, seen_mask, *, k, n_items,
                     item_block=1024, impl=None):
    """Score + seen-mask + top-K in one call.  Returns (scores f32[B, k],
    ids i32[B, k]) in (score desc, id asc) order."""
    if route(impl, ue) == "torch":
        return _ref.fused_topk_score_ref(ue, table, seen, seen_mask, k=k,
                                         item_block=item_block,
                                         n_items=n_items)
    return fused_topk_score_cuda(ue, table, seen, seen_mask, k=k,
                                 n_items=n_items, item_block=item_block)

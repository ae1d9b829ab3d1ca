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
from repro_torch.kernels.ann import ann_block_scores_cuda
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.hadamard_spmm import (STRUCTURES, hadamard_spmm_cuda,
                                               hadamard_spmm_plain)
from repro_torch.kernels.intent import intent_sddmm_cuda, intent_spmm_cuda
from repro_torch.kernels.sddmm import _Sddmm
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


def sddmm(op, x, y, src, dst, edge_mask, coeff=None, impl=None,
          groups=None):
    """One value per edge (``kernels/sddmm.py``): 'mul', 'add', 'dot' or
    'copy', +0.0 on masked edges.  'copy' scales by ``coeff`` here, while
    ``core.sparse_ops.sddmm`` takes no coeff, as in the reference.  Both
    routes run inside one autograd Function with a written-out backward.
    ``groups`` (``kernels.sddmm.EdgeGroups`` of this call's src or dst)
    sets the order in which the kernel walks the edges; the plain route
    ignores it, and the result is the same either way."""
    return _Sddmm.apply(op, x, y, src, dst, edge_mask, coeff, route(impl, x),
                        groups)


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
    plain route factors by.  The CUDA route reads none of it: it observes
    the indices, and where ``x_idx`` and ``y_idx`` are one tensor it forms
    x * y once per node and gathers one row per edge, bit for bit the
    general form's result; any other pair runs the general form."""
    if structure not in STRUCTURES:
        raise ValueError(f"structure must be one of {STRUCTURES}, "
                         f"got {structure!r}")
    if route(impl, x) == "torch":
        return hadamard_spmm_plain(x, y, indptr, x_idx, y_idx, n_nodes,
                                   scale=scale, slope=slope,
                                   structure=structure)
    return hadamard_spmm_cuda(x, y, indptr, x_idx, y_idx, n_nodes,
                              scale=scale, slope=slope)


def intent_spmm(w, x, indptr, src, n_nodes, impl=None):
    """Intent-weighted CSR aggregation (DGCF): out[v, chunk k] = sum over
    v's edges of w[e, k] * x[src_e, chunk k], K = w.shape[1] chunks of
    D/K columns (``kernels/intent.py``)."""
    if route(impl, x) == "torch":
        return _ref.intent_spmm_ref(w, x, indptr, src, n_nodes)
    return intent_spmm_cuda(w, x, indptr, src, n_nodes)


def intent_sddmm(a, b, indptr, src, n_factors, impl=None):
    """Per-edge, per-intent dots over a CSR (DGCF's agreement): s[e, k] =
    <a[row_e, chunk k], b[src_e, chunk k]>, f32[E, n_factors]
    (``kernels/intent.py``)."""
    if route(impl, a) == "torch":
        return _ref.intent_sddmm_ref(a, b, indptr, src, n_factors)
    return intent_sddmm_cuda(a, b, indptr, src, n_factors)


def embedding_bag(table, ids, mask, combiner="sum", impl=None):
    """Bags of rows: out[b] = sum_l mask[b, l] * table[ids[b, l]] ('mean'
    divides by the live count).  Beyond the reference's signature the
    port takes int64 ids as well as int32, and ``mask=None`` for every
    slot live (the row gathers of ``eval/topk.py``)."""
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


def ann_block_scores(ue, centroids_q, scale, radius, impl=None):
    """Per-block score bounds ``(u · float(ĉ_b)) · scale_b + ‖u‖₂ ·
    radius_b`` over int8 block centroids: f32[B, nb]."""
    if route(impl, ue) == "torch":
        return _ref.ann_block_scores_ref(ue, centroids_q, scale, radius)
    return ann_block_scores_cuda(ue, centroids_q, scale, radius)

"""Coarse ANN block scores — the wrapper of ``csrc/ann_block_scores.cu``.

Replaces ``src/repro/kernels/ann.py:ann_block_scores_pallas``.  For a
query ``u`` and an item block ``b`` summarised by an int8 centroid ``ĉ_b``
with its scale and radius, it computes

    (u · float(ĉ_b)) · scale_b + ‖u‖₂ · radius_b

over the whole ``[B, n_blocks]`` matrix in one launch: the score upper
bound of the block-pruned retrieval (``serving/ann.py``), or, with the
radius zeroed, the probing affinity the blocks are ranked by.

Bound on the H100: its launch at the serving shapes (B ≤ 64, 832 blocks,
D = 128: ~0.15 MB and ~14 MFLOP); operations for a sweep that stages
thousands of users.  One block per 64 × 64 output tile stages the users'
rows and the int8 centroids (converted on load) in shared memory, over D
in chunks of 32; the norm comes from the same staged chunks; the epilogue
rounds as the plain version does, so integer-valued inputs are bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def ann_block_scores_cuda(ue: torch.Tensor, centroids_q: torch.Tensor,
                          scale: torch.Tensor, radius: torch.Tensor
                          ) -> torch.Tensor:
    """ue: f32[B, D]; centroids_q: i8[nb, D]; scale, radius: f32[nb] ->
    f32[B, nb]."""
    if not ue.is_cuda:
        raise ValueError("ann_block_scores_cuda needs CUDA tensors")
    if ue.dtype != torch.float32 or ue.dim() != 2 or not ue.is_contiguous():
        raise ValueError("ue must be a contiguous float32 [B, D] tensor")
    if centroids_q.dtype != torch.int8 or centroids_q.dim() != 2 \
            or not centroids_q.is_contiguous() \
            or centroids_q.shape[1] != ue.shape[1]:
        raise ValueError("centroids_q must be a contiguous int8 [nb, D] tensor "
                         "with the width of ue")
    nb = centroids_q.shape[0]
    for t, name in ((scale, "scale"), (radius, "radius")):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous() \
                or t.numel() != nb:
            raise ValueError(f"{name} must be a contiguous float32 [nb] tensor")
    for t in (centroids_q, scale, radius):
        if t.device != ue.device:
            raise ValueError("every operand of ann_block_scores must share a "
                             "device")
    b, d = ue.shape
    out = torch.empty((b, nb), dtype=torch.float32, device=ue.device)
    if b == 0 or nb == 0:
        return out
    lib = _build.load("ann_block_scores")
    err = lib.ann_block_scores_f32(
        ue.data_ptr(), centroids_q.data_ptr(), scale.data_ptr(),
        radius.data_ptr(), out.data_ptr(), b, nb, d, ue.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(ue.device).cuda_stream))
    _build.check(lib, err, "ann_block_scores")
    ann_block_scores_cuda.launches += 1
    return out


ann_block_scores_cuda.launches = 0

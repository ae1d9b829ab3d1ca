"""Block-pruned approximate-MIPS retrieval over the item table (the port of
``repro/serving/ann.py``).

The exact streaming scorer scores every item block for every query batch.
``AnnIndex`` is the IVF/block-max answer, with the reference's rules:

  build   items are reordered so embedding-space neighbours share
          fixed-size *index blocks* (``reorder='bisect'``: recursive PCA
          median splits — deterministic and exactly balanced; ``'none'``
          keeps catalogue order); each block keeps an int8-quantized
          centroid and a radius = max member distance to the centroid
          **plus** the centroid's own quantization error.  The build runs
          in numpy on the host, copied from the reference, so one table
          gives bit-equal ``order``, ``centroids_q``, ``scale`` and
          ``radius`` in both packages.

  query   1. coarse: ``kernels.ops.ann_block_scores`` (the CUDA kernel on
             the card) scores every block's summary for every queried
             user in one launch per ``ann_topk`` call —
             ``(u·ĉ_b)·scale_b + ‖u‖·radius_b``, a valid score upper
             bound; with the radius zeroed, the probing affinity blocks
             are ranked by.
          2. prune: each user ranks the blocks by affinity; a block's
             priority is the best rank any user of the batch gave it, and
             the ``ceil(keep_frac · n_blocks)`` best survive (ties toward
             lower id).  This runs in numpy on a host copy of the
             affinities, with the reference's float-bit sort keys.
          3. exact: the survivors' rows are gathered **in ascending
             global-id order** (through whatever facade the placement
             produced, so pruning cuts slow-tier bytes) and merged by
             ``kernels.ops.fused_topk_score`` at the caller's
             ``item_block``.

Because the candidate matrix is id-sorted and the exact stage runs the
fused merge at the same block size, ``keep_frac=1.0`` keeps every block
and is bit-identical to ``eval.topk.streaming_topk``.

The planner prices the index footprint (centroids + bounds + the item
permutation) as a pinned-fast ``serve/ann_index`` profile
(``pipeline.plan.serving_profiles(ann_index_bytes=...)``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.eval.topk import (DEFAULT_ITEM_BLOCK, DEFAULT_USER_BATCH,
                                   NEG_INF, _gather_rows, _padded_seen,
                                   validate_user_ids)
from repro_torch.kernels import ops as kops
from repro_torch.memory.executor import HostResident

_ID_SENTINEL = np.iinfo(np.int32).max
DEFAULT_ANN_BLOCK = 64      # index granularity: fine blocks select well


def ann_index_nbytes(n_items: int, dim: int, block: int) -> int:
    """Static index footprint for planner pricing (before the index is
    built): int8 centroids + fp32 scale/radius per block + the int32
    item permutation."""
    n_blocks = max(1, math.ceil(n_items / max(block, 1)))
    return n_blocks * dim + 8 * n_blocks + 4 * n_items


def _bisect_order(items: np.ndarray, n_blocks: int) -> np.ndarray:
    """Pack embedding-space neighbours into contiguous slots by recursive
    PCA median splits (a balanced kd-cut), ``ceil(log2(n_blocks))`` levels
    deep: exactly balanced, deterministic (power iteration from a fixed
    vector, stable sorts).  Chunks of ``block`` consecutive slots become
    the index blocks; their centroids and radii come from the actual
    chunk members, so bounds stay valid where a chunk straddles a leaf."""
    levels = max(math.ceil(math.log2(max(n_blocks, 1))), 0)

    def split(ids: np.ndarray, depth: int) -> list[np.ndarray]:
        if depth == 0 or len(ids) <= 1:
            return [ids]
        x = items[ids]
        xc = x - x.mean(axis=0)
        v = np.ones(x.shape[1], np.float32)
        for _ in range(8):            # power iteration on the covariance
            v = xc.T @ (xc @ v)
            v /= max(np.linalg.norm(v), np.finfo(np.float32).tiny)
        srt = ids[np.argsort(xc @ v, kind="stable")]
        half = len(ids) // 2
        return split(srt[:half], depth - 1) + split(srt[half:], depth - 1)

    parts = split(np.arange(len(items), dtype=np.int64), levels)
    return np.concatenate(parts)


class AnnIndex:
    """Per-block coarse summaries over a (reordered) item table.

    Holds no item rows itself — only the permutation, the int8 centroid
    table and the per-block bound terms (with device copies for the
    coarse kernel); the exact stage gathers rows from whatever table
    serving placed.  ``device`` defaults to the table's device for a
    tensor, else to 'cuda'."""

    def __init__(self, item_e, *, block: int = DEFAULT_ANN_BLOCK,
                 reorder: str = "bisect", device=None):
        if reorder not in ("bisect", "none"):
            raise ValueError(f"ann reorder must be 'bisect' or 'none', "
                             f"got {reorder!r}")
        if device is None:
            device = item_e.device if isinstance(item_e, torch.Tensor) \
                else "cuda"
        self.device = resolve_device(device)
        if isinstance(item_e, torch.Tensor):
            item_e = item_e.detach().cpu().numpy()
        items = np.asarray(item_e, np.float32)
        self.n_items, self.dim = int(items.shape[0]), int(items.shape[1])
        self.blk = int(min(max(block, 1), max(self.n_items, 1)))
        self.n_blocks = max(1, math.ceil(self.n_items / self.blk))
        self.reorder = reorder
        if reorder == "bisect" and self.n_blocks > 1:
            self.order = _bisect_order(items, self.n_blocks)
        else:
            self.order = np.arange(self.n_items, dtype=np.int64)
        # per-block summaries from the actual chunk members
        nb, blk = self.n_blocks, self.blk
        cent = np.zeros((nb, self.dim), np.float32)
        radius = np.zeros(nb, np.float32)
        for b in range(nb):
            members = items[self.order[b * blk:(b + 1) * blk]]
            c = members.mean(axis=0)
            cent[b] = c
            radius[b] = np.linalg.norm(members - c, axis=1).max()
        # int8 symmetric centroid quantization; the dequantization error
        # is folded into the radius so the bound survives quantization
        self.scale = np.maximum(np.abs(cent).max(axis=1) / 127.0,
                                np.finfo(np.float32).tiny).astype(np.float32)
        self.centroids_q = np.clip(
            np.rint(cent / self.scale[:, None]), -127, 127).astype(np.int8)
        dequant = self.centroids_q.astype(np.float32) * self.scale[:, None]
        self.radius = (radius + np.linalg.norm(cent - dequant, axis=1)
                       ).astype(np.float32)
        # device copies for the coarse kernel (tiny, priced pinned fast)
        self._cq_dev = torch.from_numpy(self.centroids_q).to(self.device)
        self._scale_dev = torch.from_numpy(self.scale).to(self.device)
        self._radius_dev = torch.from_numpy(self.radius).to(self.device)
        self._zero_dev = torch.zeros_like(self._radius_dev)

    @property
    def nbytes(self) -> int:
        return (self.centroids_q.nbytes + self.scale.nbytes
                + self.radius.nbytes + 4 * self.n_items)

    def n_keep(self, keep_frac: float) -> int:
        if not 0.0 < float(keep_frac) <= 1.0:
            raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")
        return int(min(self.n_blocks,
                       max(1, math.ceil(float(keep_frac) * self.n_blocks))))

    def _coarse(self, ue, radius, n_valid: int, impl) -> np.ndarray:
        ue = to_device(ue, self.device, torch.float32).contiguous()
        out = kops.ann_block_scores(ue, self._cq_dev, self._scale_dev,
                                    radius, impl=impl)
        return out[:n_valid].cpu().numpy()

    def block_bounds(self, ue, n_valid: int, impl=None) -> np.ndarray:
        """Per-block score **upper bounds** for the first ``n_valid`` rows
        of a staged user batch — f32[n_valid, n_blocks]: every member's
        exact score is ``<=`` its block's bound."""
        return self._coarse(ue, self._radius_dev, n_valid, impl)

    def block_affinity(self, ue, n_valid: int, impl=None) -> np.ndarray:
        """Per-block probing affinities ``(u·ĉ_b)·scale_b`` — the same
        coarse kernel with the radius term zeroed.  Blocks are ranked by
        these: ranking on the bound would let one loose block (large
        radius) outrank genuinely close ones."""
        return self._coarse(ue, self._zero_dev, n_valid, impl)

    def select_blocks(self, affinity: np.ndarray, keep_frac: float
                      ) -> np.ndarray:
        """The shared shortlist: each user ranks every block by its own
        affinity (descending, ties toward lower block id); a block's
        priority is the best rank any user gave it, and the ``n_keep``
        best-priority blocks survive (priority ties toward lower id).
        Ranks, not affinities, are compared across users, so one
        large-norm user cannot crowd the others out.  Returned sorted
        ascending; deterministic for a given (batch, index).

        Each user's ranking is an O(n_blocks) partition of unique
        (affinity, id) keys: float bits made order-preserving under
        integer compare, the block id packed into the low half."""
        n_keep = self.n_keep(keep_frac)
        nb = self.n_blocks
        ids32 = np.arange(nb, dtype=np.uint64)
        # unique uint64 keys ordering by (affinity desc, id asc):
        # negate (canonicalizing -0.0 so +/-0.0 still tie), map float
        # bits monotonically onto uint32, append the id as low bits
        neg = np.ascontiguousarray(-np.asarray(affinity, np.float32)) \
            + np.float32(0.0)
        fb = neg.view(np.int32)
        mono = (fb ^ ((fb >> 31) | np.int32(-2**31))).view(np.uint32)
        keys = (mono.astype(np.uint64) << np.uint64(32)) | ids32[None, :]
        top = np.partition(keys, n_keep - 1, axis=1)[:, :n_keep] \
            if n_keep < nb else keys.copy()
        top.sort(axis=1)                 # column index == per-user rank
        top_ids = (top & np.uint64(0xFFFFFFFF)).astype(np.int64)
        priority = np.full(nb, nb, np.int64)
        np.minimum.at(priority, top_ids.ravel(),
                      np.broadcast_to(np.arange(n_keep),
                                      top_ids.shape).ravel())
        # n_keep best (priority, id) pairs via the same packed-key trick
        keys2 = (priority.astype(np.uint64) << np.uint64(32)) | ids32
        best = np.partition(keys2, n_keep - 1)[:n_keep] \
            if n_keep < nb else keys2
        return np.sort((best & np.uint64(0xFFFFFFFF)).astype(np.int64))

    def candidate_ids(self, kept: np.ndarray) -> tuple[np.ndarray, int]:
        """Global item ids of the kept blocks, sorted ascending and padded
        with ``_ID_SENTINEL`` to the static ``n_keep·blk`` width.  Returns
        (ids i64[C], n_valid).  Ascending order is what makes the exact
        stage's positional tie-break equal the global (score desc, id
        asc) contract."""
        slots = (kept[:, None] * self.blk + np.arange(self.blk)[None, :]
                 ).ravel()
        valid = slots < self.n_items
        ids = np.full(len(slots), _ID_SENTINEL, np.int64)
        ids[valid] = self.order[slots[valid]]
        ids.sort()                       # sentinels land at the tail
        return ids, int(valid.sum())

    def describe(self) -> str:
        return (f"AnnIndex[{self.n_items}I x {self.dim}D] "
                f"blocks={self.n_blocks}x{self.blk} reorder={self.reorder} "
                f"index={self.nbytes}B")


def _gather_candidates(item_e, ids: np.ndarray, n_valid: int, dim: int,
                       device: torch.device) -> torch.Tensor:
    """Candidate rows for the exact stage, through the placed table: a
    host facade streams (and cache-counts) only the valid rows; a device
    table gathers in place.  Pad slots carry zeros or row 0 — they are
    position-masked by ``n_items=n_valid`` in the fused merge."""
    if isinstance(item_e, HostResident):
        rows = torch.zeros((len(ids), dim), dtype=torch.float32,
                           device=device)
        if n_valid:
            rows[:n_valid] = item_e.block(ids[:n_valid])
        return rows
    safe = np.where(ids < _ID_SENTINEL, ids, 0)
    return item_e.index_select(0, torch.from_numpy(safe).to(device))


@torch.inference_mode()
def ann_topk(index: AnnIndex, user_e, item_e, k: int, *,
             keep_frac: float = 1.0, user_ids=None,
             seen_indptr=None, seen_items=None,
             user_batch: int = DEFAULT_USER_BATCH,
             item_block: int = DEFAULT_ITEM_BLOCK,
             impl: str | None = None):
    """Approximate top-K through the block-pruned index — the counterpart
    of ``eval.topk.streaming_topk`` (same (scores, ids) numpy return, same
    -1/-inf invalid slots).  Tensors and numpy tables are served on the
    index's device; ``HostResident`` facades stream their rows there.
    ``item_block`` is the exact-merge block size; with the exact sweep's
    ``item_block``, ``keep_frac=1.0`` is bit-identical to it."""
    dev = index.device
    user_host = user_e if isinstance(user_e, HostResident) else None
    item_host = item_e if isinstance(item_e, HostResident) else None
    if user_host is None:
        user_e = to_device(user_e, dev, torch.float32).contiguous()
    if item_host is None:
        item_e = to_device(item_e, dev, torch.float32).contiguous()
    n_users = int(user_e.shape[0])
    if user_ids is None:
        user_ids = np.arange(n_users, dtype=np.int32)
    user_ids = np.asarray(user_ids, np.int32)
    validate_user_ids(user_ids, n_users)
    n_q = len(user_ids)
    k = int(k)
    index.n_keep(keep_frac)              # validate before any work
    if n_q == 0 or index.n_items == 0:
        return (np.full((n_q, k), NEG_INF, np.float32),
                np.full((n_q, k), -1, np.int32))
    ub = int(min(user_batch, n_q))
    max_deg = 0
    if seen_indptr is not None:
        seen_indptr = to_device(seen_indptr, dev, torch.int64)
        seen_items = to_device(seen_items, dev, torch.int64)
        users = torch.from_numpy(user_ids).to(dev).long()
        max_deg = int((seen_indptr[users + 1] - seen_indptr[users]).max())

    # stage ALL query user rows + coarse affinities up front: one gather
    # and one coarse-kernel launch for the whole call; the batch loop
    # then only selects, gathers candidates and merges
    n_pad = math.ceil(n_q / ub) * ub
    ids_p = np.pad(user_ids, (0, n_pad - n_q))
    ue_all = user_host.take(ids_p) if user_host is not None \
        else _gather_rows(user_e, torch.from_numpy(ids_p).to(dev), impl)
    aff_all = index.block_affinity(ue_all[:n_q], n_q, impl)

    tops = []
    for lo in range(0, n_q, ub):
        b = min(ub, n_q - lo)
        ue = ue_all[lo:lo + b]
        # 1. coarse affinities of the batch's real users; 2. the shortlist
        kept = index.select_blocks(aff_all[lo:lo + b], keep_frac)
        cand_ids, n_valid = index.candidate_ids(kept)
        # 3. exact merge over the id-sorted candidates
        cand = _gather_candidates(item_e, cand_ids, n_valid, index.dim, dev)
        cand_t = torch.from_numpy(cand_ids).to(dev)
        sel = torch.from_numpy(user_ids[lo:lo + b]).to(dev)
        if seen_indptr is not None:
            seen, smask = _padded_seen(sel, seen_indptr, seen_items, max_deg)
        else:
            seen = torch.zeros((b, 0), dtype=torch.int32, device=dev)
            smask = torch.zeros((b, 0), dtype=torch.bool, device=dev)
        # seen ids -> candidate positions (id-sorted, so searchsorted);
        # out-of-shortlist seen items simply aren't candidates
        seen = seen.long()
        pos = torch.searchsorted(cand_t, seen)
        pos_c = torch.clamp(pos, max=len(cand_ids) - 1)
        smask = (smask & (cand_t[pos_c] == seen)).contiguous()
        top_s, top_p = kops.fused_topk_score(
            ue, cand, pos_c.to(torch.int32).contiguous(), smask, k=k,
            n_items=n_valid, item_block=int(min(item_block, max(n_valid, 1))),
            impl=impl)
        # candidate positions -> global ids (invalid slots stay -1)
        ids_g = torch.where(top_p >= 0, cand_t[top_p.long().clamp_min(0)],
                            -1).to(torch.int32)
        tops.append((top_s, ids_g))
    out_s = torch.cat([s for s, _ in tops]).cpu().numpy()
    out_i = torch.cat([i for _, i in tops]).cpu().numpy()
    return out_s, out_i


def recall_against(exact_ids: np.ndarray, approx_ids: np.ndarray) -> float:
    """Mean per-user recall of ``approx_ids`` against ``exact_ids`` (both
    [n, k]; -1 slots ignored)."""
    hits, total = 0, 0
    for ex, ap in zip(np.asarray(exact_ids), np.asarray(approx_ids)):
        truth = set(int(i) for i in ex if i >= 0)
        if not truth:
            continue
        got = set(int(i) for i in ap if i >= 0)
        hits += len(truth & got)
        total += len(truth)
    return hits / total if total else 1.0

"""Ranking metrics over streamed top-K lists — recall@K, NDCG@K, MRR (the
port of ``repro/eval/metrics.py``; host numpy, bit-equal to it).

All three share one ranked-hits core: ``ranked_hits`` turns a top-K id
matrix plus per-user held-out item lists into a boolean hit matrix, and
each metric is a different reduction of it.  Everything runs host-side
in float64 numpy — metric math is trivially cheap next to scoring, and
float64 keeps the streamed and dense-oracle paths bit-for-bit equal
(pinned by tests/test_eval.py).

Users with zero held-out items are excluded from every average (they
have no defined recall); invalid top-K slots (id -1, from catalogues
smaller than K or fully-masked users) never count as hits.
"""
from __future__ import annotations

import numpy as np

from repro_torch.eval.topk import streaming_topk


def ranked_hits(topk_ids: np.ndarray, test_pos: list[np.ndarray]) -> np.ndarray:
    """hits[u, j] = (topk_ids[u, j] in test_pos[u]).  topk_ids: i32[n, K]
    with -1 for invalid slots (never a hit — item ids are >= 0)."""
    topk_ids = np.asarray(topk_ids)
    n, _ = topk_ids.shape
    if n != len(test_pos):
        raise ValueError(f"{n} ranked rows vs {len(test_pos)} test lists")
    hits = np.zeros(topk_ids.shape, bool)
    for u, pos in enumerate(test_pos):
        if len(pos):
            hits[u] = np.isin(topk_ids[u], pos)
    return hits


def ranking_metrics(topk_ids: np.ndarray, test_pos: list[np.ndarray],
                    ks: tuple[int, ...] = (20,)) -> dict[str, float]:
    """recall@K / NDCG@K for each K in ``ks`` (capped at the ranked list
    width) plus MRR over the full ranked list, averaged over users with
    at least one held-out item."""
    hits = ranked_hits(topk_ids, test_pos)
    n_test = np.array([len(p) for p in test_pos], np.int64)
    evalable = n_test > 0
    out: dict[str, float] = {}
    width = hits.shape[1]
    discount = 1.0 / np.log2(np.arange(2, width + 2))   # float64
    ideal = np.cumsum(discount)
    for k in ks:
        k = min(int(k), width)
        h = hits[:, :k]
        recall = h.sum(axis=1) / np.maximum(n_test, 1)
        dcg = (h * discount[:k]).sum(axis=1)
        idcg = ideal[np.minimum(np.maximum(n_test, 1), k) - 1]
        ndcg = dcg / idcg
        out[f"recall@{k}"] = float(recall[evalable].mean()) \
            if evalable.any() else 0.0
        out[f"ndcg@{k}"] = float(ndcg[evalable].mean()) \
            if evalable.any() else 0.0
    any_hit = hits.any(axis=1)
    first = hits.argmax(axis=1)
    rr = np.where(any_hit, 1.0 / (first + 1.0), 0.0)
    out["mrr"] = float(rr[evalable].mean()) if evalable.any() else 0.0
    return out


def evaluate_embeddings(user_e, item_e, test_pos: list[np.ndarray], *,
                        k: int = 20, ks: tuple[int, ...] | None = None,
                        seen_indptr=None, seen_items=None,
                        user_batch: int = 256, item_block: int = 1024,
                        impl: str | None = None,
                        device=None) -> dict[str, float]:
    """Held-out ranking evaluation through the streaming top-K path.

    Only users with at least one held-out item are scored (the others
    cannot affect any average), so eval cost scales with the test set,
    not the user catalogue.  ``seen_indptr``/``seen_items`` is the
    user-CSR of training interactions to exclude from the ranking.
    """
    ks = tuple(ks) if ks is not None else (int(k),)
    width = max(ks)
    eval_users = np.array([u for u, p in enumerate(test_pos) if len(p)],
                          np.int32)
    if len(eval_users) == 0:
        return ranking_metrics(np.zeros((0, width), np.int32), [], ks=ks)
    _, ids = streaming_topk(user_e, item_e, width, user_ids=eval_users,
                            seen_indptr=seen_indptr, seen_items=seen_items,
                            user_batch=user_batch, item_block=item_block,
                            impl=impl, device=device)
    return ranking_metrics(ids, [test_pos[u] for u in eval_users], ks=ks)

"""Recommender — the serving facade over final embeddings (the port of
``repro/eval/recommender.py``).

Both tables are moved to the device once and stay resident; the train
user-CSR (the seen-item exclusion set) lives there too, so each query
batch pads its seen lists on the device.  Queries run through the
streaming scorer's fused route: one ``embedding_bag`` gather and one
``fused_topk_score`` launch per user batch.

The reference's placement knobs need the planner, tiers, hot-row cache,
ANN index and int8 store, which later slices port.  Until then only
their defaults are accepted — ``cache_rows=0``, ``ann=False``,
``embed_store='fp32'``, no ``hbm_budget`` and no ``pins`` — which is what
the reference's greedy policy gives at these sizes (both tables fast).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.eval.topk import (DEFAULT_ITEM_BLOCK, DEFAULT_USER_BATCH,
                                   streaming_topk, validate_user_ids)


class Recommender:
    """Batched top-K retrieval over a snapshot of final embeddings."""

    def __init__(self, user_e, item_e, *, seen_indptr=None, seen_items=None,
                 k: int = 20, user_batch: int = DEFAULT_USER_BATCH,
                 item_block: int = DEFAULT_ITEM_BLOCK,
                 impl: str | None = None, device="cuda",
                 hbm_budget: int | None = None, pins: dict | None = None,
                 embed_store: str = "fp32", cache_rows: int = 0,
                 fused: bool | None = None, ann: bool = False):
        unported = {"hbm_budget": hbm_budget is not None,
                    "pins": bool(pins), "embed_store": embed_store != "fp32",
                    "cache_rows": cache_rows != 0, "ann": bool(ann)}
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"Recommender knobs {asked} need the planner, tiers, cache "
                "or ANN index, which the port does not have yet")
        dev = resolve_device(device)
        self.device = dev
        self.k = int(k)
        self.user_batch = int(user_batch)
        self.item_block = int(item_block)
        self.impl = impl
        self.fused = fused
        self.user_e = to_device(user_e, dev, torch.float32).contiguous()
        self.item_e = to_device(item_e, dev, torch.float32).contiguous()
        self.n_users = int(self.user_e.shape[0])
        self.n_items = int(self.item_e.shape[0])
        self.seen_indptr = None if seen_indptr is None \
            else to_device(seen_indptr, dev, torch.int64)
        self.seen_items = None if seen_items is None \
            else to_device(seen_items, dev, torch.int64)

    def recommend(self, user_ids, k: int | None = None,
                  exclude_seen: bool = True):
        """Top-K (ids, scores) numpy arrays for a batch of user ids.
        Invalid slots (fewer than K unseen candidates) are (-1, -inf)."""
        k = self.k if k is None else int(k)
        si, sv = (self.seen_indptr, self.seen_items) if exclude_seen \
            else (None, None)
        user_ids = np.asarray(user_ids)
        validate_user_ids(user_ids, self.n_users)
        scores, ids = streaming_topk(
            self.user_e, self.item_e, k, user_ids=user_ids,
            seen_indptr=si, seen_items=sv, user_batch=self.user_batch,
            item_block=self.item_block, impl=self.impl, fused=self.fused)
        return ids, scores

    def describe(self) -> str:
        return (f"Recommender[{self.n_users}U x {self.n_items}I] "
                f"impl={self.impl or 'auto'} k={self.k} "
                f"block={self.item_block} device={self.device} "
                f"user_embed->device item_embed->device")

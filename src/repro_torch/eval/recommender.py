"""Recommender — the serving facade over final embeddings (the port of
``repro/eval/recommender.py``).

Snapshots a model's final (user, item) embeddings, places them across the
memory tiers with the reference's policy registry (serving traffic
profile: the item table is streamed for every query batch, the user
table only row-gathered for the batch's users), and answers batched
top-K queries through the streaming scorer or the ANN index.

Placement: ``serving_profiles`` → ``get_policy(policy)`` over
``topology`` (default ``tpu-hbm-host`` with ``greedy``, the reference's
defaults, so one spec drives both packages) → ``TieredExecutor.host_table``.
A fast-tier table moves to the serving device once.  A demoted table
stays in a host store behind the ``HostResident`` facade (int8 rows in
``QuantizedHostResident`` with ``embed_store='int8'``), and only each
query's rows cross the host link.  The port has no memory kinds and
always uses this host store: on ``tpu-hbm-host`` the reference's JAX CPU
backend instead places a demoted table on its ``pinned_host`` memory kind
and builds no facade and no cache (and cannot gather from it there), so
compare cache counters only on topologies whose tiers have no memory kind
(``uniform``, ``dram-optane-*``), and on ``tpu-hbm-host`` compare ids and
scores with the reference's all-fast placement.  See
``memory/executor.py``.

Serving knobs (the reference's ``ServeCfg``): ``cache_rows`` puts a
device-resident LFU ``HotRowCache`` in front of every host-demoted table
(its slot budget priced against the fast tier); ``fused`` routes scoring
through the fused score + top-K kernel (auto on for a device-resident
item table); ``ann`` builds a block-pruned ``serving.ann.AnnIndex`` over
the *served* item bytes — after placement, from exactly the rows the
exact stage will score (the int8 round-trip included), so its bounds hold
for every storage arm — and routes ``recommend`` through ``ann_topk``;
its footprint is priced pinned-fast as ``serve/ann_index``.  Every knob
is bit-identical to the plain exact sweep where it should be: cache on or
off, host or device tables, and ``keep_frac=1.0``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.eval.topk import (DEFAULT_ITEM_BLOCK, DEFAULT_USER_BATCH,
                                   streaming_topk, validate_user_ids)
from repro_torch.memory import (HostResident, QuantizedHostResident,
                                TieredExecutor, get_policy, get_topology,
                                quantized_table_bytes)
from repro_torch.memory.cache import HotRowCache
from repro_torch.pipeline.plan import serving_profiles

# repro_torch.serving.ann is imported inside Recommender: it consumes
# repro_torch.eval.topk, so a module-level import here would cycle
# through the package __init__s.


def _served_rows(table) -> np.ndarray:
    """The dense fp32 host view of whatever placement produced — the bytes
    a gather will actually return (cache → its backing store; int8 → the
    dequantized round-trip; a tensor → itself)."""
    if isinstance(table, HotRowCache):
        return _served_rows(table.backing)
    if isinstance(table, QuantizedHostResident):
        return table.dense()
    if isinstance(table, HostResident):
        return table.arr.numpy().astype(np.float32, copy=False)
    return table.detach().cpu().numpy().astype(np.float32, copy=False)


def _nbytes(table) -> int:
    return int(table.numel() * table.element_size()) \
        if isinstance(table, torch.Tensor) else int(np.asarray(table).nbytes)


class Recommender:
    """Batched top-K retrieval over a snapshot of final embeddings."""

    def __init__(self, user_e, item_e, *, seen_indptr=None, seen_items=None,
                 k: int = 20, user_batch: int = DEFAULT_USER_BATCH,
                 item_block: int = DEFAULT_ITEM_BLOCK,
                 impl: str | None = None, hbm_budget: int | None = None,
                 topology="tpu-hbm-host", policy: str = "greedy",
                 pins: dict | None = None, embed_store: str = "fp32",
                 cache_rows: int = 0, fused: bool | None = None,
                 ann: bool = False, keep_frac: float = 1.0,
                 ann_block: int | None = None, ann_reorder: str = "bisect",
                 device="cuda"):
        from repro_torch.serving.ann import (DEFAULT_ANN_BLOCK, AnnIndex,
                                             ann_index_nbytes)
        dev = resolve_device(device)
        self.device = dev
        self.k = int(k)
        self.user_batch = int(user_batch)
        self.item_block = int(item_block)
        self.impl = impl
        self.cache_rows = int(cache_rows)
        self.fused = fused
        self.ann = bool(ann)
        self.keep_frac = float(keep_frac)
        self.seen_indptr = None if seen_indptr is None \
            else to_device(seen_indptr, dev, torch.int64)
        self.seen_items = None if seen_items is None \
            else to_device(seen_items, dev, torch.int64)

        # fp32 tables, where they already lie (a device tensor stays put)
        user_e, item_e = (t.detach().float() if isinstance(t, torch.Tensor)
                          else np.asarray(t, np.float32)
                          for t in (user_e, item_e))
        topo = get_topology(topology)
        budgets = topo.capacities()
        if hbm_budget is not None:
            budgets[topo.fast.name] = int(hbm_budget)
        self.ann_block = int(ann_block) if ann_block is not None \
            else DEFAULT_ANN_BLOCK
        n_items, dim = int(item_e.shape[0]), int(item_e.shape[-1])
        row = dim * 4
        ann_bytes = ann_index_nbytes(n_items, dim, self.ann_block) \
            if self.ann else 0
        profs = serving_profiles(_nbytes(user_e), _nbytes(item_e), row,
                                 cache_rows=self.cache_rows,
                                 ann_index_bytes=ann_bytes)
        if embed_store == "int8":
            # demoted tables live quantized (~1/4 bytes): price the
            # placement on their stored footprint
            profs = [p if p.name == "serve/hot_cache" else
                     dataclasses.replace(
                         p, store_bytes=quantized_table_bytes(
                             int(p.nbytes // row), row)) for p in profs]
        self.plan = get_policy(policy)(profs, topo, budgets=budgets,
                                       pins=pins)
        self._executor = TieredExecutor(self.plan, embed_store=embed_store,
                                        cache_rows=self.cache_rows,
                                        device=dev)

        def place_table(name, table):
            placed = self._executor.host_table(name, table)
            # fast-tier tables move to the device once, so every
            # recommend() reuses them
            return placed if isinstance(placed, HostResident) \
                else to_device(placed, dev, torch.float32).contiguous()

        self.user_e = place_table("serve/user_embed", user_e)
        self.item_e = place_table("serve/item_embed", item_e)
        self.n_offloaded = sum(
            1 for n in ("serve/user_embed", "serve/item_embed")
            if not self.plan.is_fast(n))
        self.n_users = int(self.user_e.shape[0])
        self.n_items = int(self.item_e.shape[0])
        # the ANN index summarizes the *served* bytes — built after
        # placement so the bounds hold for the rows the exact stage will
        # actually score (int8 dequant round-trip included)
        t0 = time.perf_counter()
        self.ann_index = AnnIndex(_served_rows(self.item_e),
                                  block=self.ann_block, reorder=ann_reorder,
                                  device=dev) if self.ann else None
        self.index_build_s = time.perf_counter() - t0 if self.ann else 0.0
        if self.ann_index is not None:
            self.ann_index.n_keep(self.keep_frac)   # fail fast on bad knob

    @classmethod
    def from_pipeline(cls, pipeline, state, **kw) -> "Recommender":
        """Snapshot a ``pipeline.Pipeline``: final forward embeddings + the
        train CSR as the seen-item exclusion set, placed on the pipeline's
        own topology, policy, budget, pins and table store, and served on
        its device."""
        user_e, item_e = pipeline.embeddings(state)
        indptr, items = pipeline.g.seen_csr()
        cfg = pipeline.cfg
        kw.setdefault("impl", pipeline.g.impl)
        kw.setdefault("device", pipeline.device)
        kw.setdefault("topology", pipeline.topology)
        kw.setdefault("policy", cfg.memory_policy)
        kw.setdefault("hbm_budget", cfg.hbm_budget)
        kw.setdefault("pins", cfg.memory_pins)
        kw.setdefault("embed_store", cfg.embed_store)
        return cls(user_e, item_e, seen_indptr=indptr, seen_items=items, **kw)

    def recommend(self, user_ids, k: int | None = None,
                  exclude_seen: bool = True):
        """Top-K (ids, scores) numpy arrays for a batch of user ids.
        Invalid slots (fewer than K unseen candidates) are (-1, -inf)."""
        k = self.k if k is None else int(k)
        si, sv = (self.seen_indptr, self.seen_items) if exclude_seen \
            else (None, None)
        user_ids = np.asarray(user_ids)
        validate_user_ids(user_ids, self.n_users)
        if self.ann_index is not None:
            from repro_torch.serving.ann import ann_topk
            scores, ids = ann_topk(
                self.ann_index, self.user_e, self.item_e, k,
                keep_frac=self.keep_frac, user_ids=user_ids,
                seen_indptr=si, seen_items=sv,
                user_batch=self.user_batch, item_block=self.item_block,
                impl=self.impl)
        else:
            scores, ids = streaming_topk(
                self.user_e, self.item_e, k, user_ids=user_ids,
                seen_indptr=si, seen_items=sv, user_batch=self.user_batch,
                item_block=self.item_block, impl=self.impl,
                fused=self.fused, device=self.device)
        return ids, scores

    def cache_stats(self) -> dict[str, dict]:
        """Per-table hot-row cache counters (hits, misses, bytes
        streamed, hit_rate); empty when ``cache_rows == 0`` or nothing
        is host-demoted."""
        return self._executor.cache_stats()

    def prefill_cache(self, user_ids=None) -> None:
        """Warm the hot-row caches: stream the given user rows (all the
        cache fits by default) into the device-resident slots up front."""
        for name, cache in self._executor.caches.items():
            if name == "serve/user_embed":
                ids = np.arange(cache.rows) if user_ids is None \
                    else np.asarray(user_ids)
                self._executor.prefetch_rows(name, ids)

    def describe(self) -> str:
        tiers = {n: p.tier for n, p in self.plan.placements.items()}
        cache = ""
        stats = self.cache_stats()
        if stats:
            parts = [f"{n.split('/')[-1]}: rows={self._executor.caches[n].rows} "
                     f"hit_rate={s['hit_rate']:.2f} "
                     f"streamed={s['bytes_streamed']}B"
                     for n, s in stats.items()]
            cache = f" cache[{'; '.join(parts)}]"
        ann = ""
        if self.ann_index is not None:
            ann = (f" ann[{self.ann_index.describe()} "
                   f"keep_frac={self.keep_frac:g}]")
        return (f"Recommender[{self.n_users}U x {self.n_items}I] "
                f"impl={self.impl or 'auto'} k={self.k} "
                f"block={self.item_block} device={self.device} "
                f"topology={self.plan.topology.name} "
                f"policy={self.plan.policy} "
                f"user_embed->{tiers['serve/user_embed']} "
                f"item_embed->{tiers['serve/item_embed']} "
                f"(offloaded={self.n_offloaded}){cache}{ann}")

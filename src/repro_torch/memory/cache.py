"""HotRowCache — a software-managed device-resident cache for slow-tier
embedding rows (the port of ``repro/memory/cache.py``).

Embedding access under production traffic is sharply Zipfian (RecNMP,
PAPERS.md): a small hot set of rows serves most requests.  A demoted
serving table keeps its bytes in the host store, and a fixed budget of
device-resident row slots absorbs the hot set, so steady-state Zipfian
traffic streams only the cold tail over the host link.

Policy, as the reference's: LFU residency with an admission filter
(TinyLFU-style).  Every requested row bumps a frequency counter whether or
not it is resident; a miss is admitted into a free slot unconditionally,
but once the cache is full it only displaces the coldest resident when the
newcomer's frequency is strictly higher.  Eviction is deterministic (first
minimum-frequency slot).

Where things live: the bookkeeping (``_freq``, ``_slot_of``, ``_slot_ids``,
``_free``) is numpy on the host and decides admissions row by row in the
reference's order; the slot store is a tensor on the serving device.  One
query's admissions become one device scatter whose content per slot is the
last row admitted there (a row admitted early in a query can be displaced
by a later one, as in the reference).  The query's output is gathered from
the store before that scatter is issued, so this query's evictions never
corrupt its own rows (stream order keeps the two apart).

Bit-identity: a cached row is the row ``backing.take`` returns (the
dequantized fp32 view for the int8 store), so cache-on serving returns
exactly the cache-off results.  The counters equal the reference's,
``bytes_streamed`` included (fp32 bytes of the misses, also for the int8
store).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.memory.executor import HostResident


@dataclasses.dataclass
class CacheStats:
    """Hit/miss accounting in *distinct rows per query* (a row requested
    twice in one batch costs one lookup, like one gather)."""
    hits: int = 0
    misses: int = 0
    bytes_streamed: int = 0
    fills: int = 0
    evictions: int = 0
    queries: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "hit_rate": self.hit_rate}


class HotRowCache(HostResident):
    """LFU device-resident row cache over a slow-tier table facade.

    Subclasses ``HostResident`` so serving code that routes on the facade
    type streams through the cache transparently; ``take``/``block``
    return rows bit-identical to the uncached gather, with only the misses
    counted as slow-tier traffic."""

    def __init__(self, backing: HostResident, rows: int):
        if not isinstance(backing, HostResident):
            backing = HostResident(backing)
        self.backing = backing
        self.device = backing.device
        n, d = backing.shape
        self.rows = int(min(max(rows, 0), n))
        self.stats = CacheStats()
        self._freq = np.zeros(n, np.int64)
        self._slot_of = np.full(n, -1, np.int64)           # row -> slot
        self._slot_ids = np.full(self.rows, -1, np.int64)  # slot -> row
        self._free = list(range(self.rows - 1, -1, -1))
        # the fast-tier slot pool
        self._store = torch.zeros((self.rows, d), dtype=torch.float32,
                                  device=self.device)

    shape = property(lambda self: self.backing.shape)
    dtype = property(lambda self: torch.float32)
    nbytes = property(lambda self: self.backing.nbytes)
    link_bytes = property(lambda self: self.backing.link_bytes)

    @property
    def resident_rows(self) -> int:
        return self.rows - len(self._free)

    def _admit(self, rows: np.ndarray, data: torch.Tensor) -> None:
        """Fill free slots; once full, displace the coldest resident only
        when the newcomer is strictly hotter (first-min eviction).  The
        slots are decided here on the host; one scatter then writes each
        slot's last admitted row.

        The coldest resident comes from a heap of (frequency, slot): its
        top is the reference's ``argmin`` over the slots (lowest
        frequency, then lowest slot), and frequencies do not change
        during one admission, so each rejected miss costs O(1) and each
        eviction O(log rows) instead of a scan of every slot."""
        last = {}                                  # slot -> index into rows
        heap = None
        for j, r in enumerate(rows):
            if self._free:
                s = self._free.pop()
            else:
                if heap is None:                   # the cache just filled
                    heap = list(zip(self._freq[self._slot_ids].tolist(),
                                    range(self.rows)))
                    heapq.heapify(heap)
                coldest, v = heap[0]
                if self._freq[r] <= coldest:
                    continue                       # admission filter
                heapq.heapreplace(heap, (int(self._freq[r]), v))
                self._slot_of[self._slot_ids[v]] = -1
                self.stats.evictions += 1
                s = v
            self._slot_ids[s] = r
            self._slot_of[r] = s
            last[s] = j
            self.stats.fills += 1
        if last:
            slots = torch.tensor(list(last), dtype=torch.int64)
            src = torch.tensor(list(last.values()), dtype=torch.int64)
            self._store[slots.to(self.device)] = data[src.to(self.device)]

    def take(self, ids) -> torch.Tensor:
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
        uniq, inv = np.unique(ids, return_inverse=True)
        self.stats.queries += 1
        self._freq[uniq] += 1
        slots = self._slot_of[uniq]
        resident = slots >= 0
        self.stats.hits += int(resident.sum())
        # assemble the output from the *pre-admission* store: this
        # query's evictions must not corrupt this query's rows
        out = torch.empty((len(uniq), self.shape[1]), dtype=torch.float32,
                          device=self.device)
        if resident.any():
            hit_pos = torch.from_numpy(np.nonzero(resident)[0]).to(self.device)
            hit_slots = torch.from_numpy(slots[resident]).to(self.device)
            out[hit_pos] = self._store[hit_slots]
        missed = uniq[~resident]
        self.stats.misses += len(missed)
        if len(missed):
            streamed = self.backing.take(missed).float()
            self.stats.bytes_streamed += len(missed) * self.shape[1] * 4
            miss_pos = torch.from_numpy(np.nonzero(~resident)[0])
            out[miss_pos.to(self.device)] = streamed
            self._admit(missed, streamed)
        return out[torch.from_numpy(inv.reshape(-1)).to(self.device)]

    def block(self, ids) -> torch.Tensor:
        return self.take(ids)

    def prefill(self, ids) -> None:
        """Warm the cache: stream the given rows up front, without counting
        them as serving hits or misses."""
        ids = np.unique(np.asarray(ids))
        self._freq[ids] += 1
        missed = ids[self._slot_of[ids] < 0]
        if len(missed):
            data = self.backing.take(missed).float()
            self.stats.bytes_streamed += len(missed) * self.shape[1] * 4
            self._admit(missed, data)

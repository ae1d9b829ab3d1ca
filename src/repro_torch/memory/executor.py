"""TieredExecutor, serving half — makes a placement Plan functional for the
serving tables (the port of ``repro/memory/executor.py``: ``HostResident``,
``QuantizedHostResident`` and ``TieredExecutor.host_table`` with its
queries; ``place``/``fetch``/``commit``, the training half, are ROADMAP A5).

**Host store only.**  PyTorch has no memory kinds, so the port always takes
the reference's *host-store path*: a table placed off the fast tier keeps
its bytes in a CPU tensor — pinned when the serving device is CUDA — and
only the rows a query needs cross the host link:

  * ``HostResident.take(ids)``: an index gather on the host into a fresh
    pinned buffer, then one ``non_blocking`` host-to-device copy.  The
    buffer comes from PyTorch's caching pinned allocator, which records
    the copy's stream and does not hand the block out again before the
    copy has finished, so no staging buffer is overwritten under a copy
    in flight.
  * ``QuantizedHostResident`` (``embed_store='int8'``): the store holds
    per-row symmetric int8 values plus one fp32 scale per row, quantized
    by the same numpy function as the reference, so the stored bytes are
    equal.  ``take`` ships the int8 rows and their scales and dequantizes
    on the device with one ``q.float() * scale`` — IEEE multiplication,
    so the same bits as the reference's numpy multiply.

Every facade counts ``link_bytes``: the bytes its gathers moved over the
host link (int8 rows plus scales for the quantized store).  The hot-row
cache's ``bytes_streamed`` counter, which must equal the reference's,
counts the dequantized fp32 bytes of its misses instead, so ``link_bytes``
is what shows the int8 store's capacity-tier saving.

**Divergence from the reference on JAX-CPU.**  The reference takes its
host-store path only where the tier has no JAX memory kind that the
backend exposes.  Its CPU backend exposes ``pinned_host``, so on the
``tpu-hbm-host`` preset it ``device_put``s a demoted table there and
builds neither a ``HostResident`` facade nor a ``HotRowCache``: its cache
counters stay empty while the port's count (and its scorer's gathers
then refuse the mixed memory spaces on that backend, so it cannot serve
such a table there at all).  Facade types and cache counters are
comparable only on topologies whose tiers have ``memory_kind=None``
(``uniform``, ``dram-optane-*``); on ``tpu-hbm-host`` the port's ids and
scores are held against the reference's all-fast placement, since
placement never changes results.  A parity test that compares cache
counters must never use ``tpu-hbm-host``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.memory.policies import Plan
from repro_torch.optim.compression import (dequantize_rows_int8,
                                           quantize_rows_int8)


def _host_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A CPU tensor holding ``arr``, pinned when rows go to a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.pin_memory() if device.type == "cuda" else t.clone()


def _host_ids(ids) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.detach().to("cpu", torch.int64)
    return torch.from_numpy(np.asarray(ids, np.int64).reshape(-1))


class HostResident:
    """A slow-tier table: bytes live in a host tensor, rows stream to the
    serving device on demand.  ``shape``/``dtype``/``nbytes`` mirror the
    table's so callers can treat it like one."""

    def __init__(self, arr, device="cuda"):
        self.device = resolve_device(device)
        self.arr = _host_tensor(np.asarray(arr), self.device)
        self.link_bytes = 0

    shape = property(lambda self: tuple(self.arr.shape))
    dtype = property(lambda self: self.arr.dtype)
    nbytes = property(lambda self: self.arr.numel() * self.arr.element_size())

    def _gather(self, src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``src[ids]`` on the serving device: a host gather into a
        (pinned) buffer, then one asynchronous copy."""
        buf = torch.empty((len(ids), *src.shape[1:]), dtype=src.dtype,
                          pin_memory=self.device.type == "cuda")
        torch.index_select(src, 0, ids, out=buf)
        self.link_bytes += buf.numel() * buf.element_size()
        return buf.to(self.device, non_blocking=True)

    def take(self, ids) -> torch.Tensor:
        """Row-granular gather: only the requested rows leave the host
        store (O(len(ids) × D) bytes)."""
        return self._gather(self.arr, _host_ids(ids))

    def block(self, ids) -> torch.Tensor:
        """The scorer's item-block stream (same gather as ``take``)."""
        return self.take(ids)


class QuantizedHostResident(HostResident):
    """An int8-stored slow-tier table: the host store holds per-row int8
    values plus one fp32 scale per row (~1/4 the dense bytes); rows ship
    quantized and dequantize on the serving device."""

    def __init__(self, arr, device="cuda"):
        self.device = resolve_device(device)
        arr = np.asarray(arr, np.float32)
        q, scale = quantize_rows_int8(arr)
        self.q = _host_tensor(q, self.device)
        self.scale = _host_tensor(scale, self.device)
        self._shape = tuple(arr.shape)
        self.link_bytes = 0

    shape = property(lambda self: self._shape)
    dtype = property(lambda self: torch.float32)
    nbytes = property(lambda self: self.q.numel() + 4 * self.scale.numel())

    def dense(self) -> np.ndarray:
        """The full dequantized fp32 view, on the host."""
        return dequantize_rows_int8(self.q.numpy(), self.scale.numpy())

    def take(self, ids) -> torch.Tensor:
        ids = _host_ids(ids)
        q = self._gather(self.q, ids)
        scale = self._gather(self.scale, ids)
        return q.float() * scale


class TieredExecutor:
    """Drives one Plan's serving placements: every table placed off the
    fast tier goes to the host store."""

    def __init__(self, plan: Plan, embed_store: str = "fp32",
                 cache_rows: int = 0, device="cuda"):
        if embed_store not in ("fp32", "int8"):
            raise ValueError(f"unknown embed_store {embed_store!r}; "
                             "known: fp32, int8")
        if cache_rows < 0:
            raise ValueError(f"cache_rows must be >= 0, got {cache_rows}")
        self.plan = plan
        self.topology = plan.topology
        self.embed_store = embed_store
        self.cache_rows = int(cache_rows)
        self.device = resolve_device(device)
        # hot-row caches wrapped around host-store serving tables
        self.caches: dict[str, object] = {}
        # int8 host stores: name -> the quantized facade
        self._int8: dict[str, QuantizedHostResident] = {}

    # ------------------------------------------------------------ queries
    def _demoted_tier(self, name: str):
        pl = self.plan.placements.get(name)
        if pl is None or pl.tier == self.topology.fast.name:
            return None
        return self.topology.tier(pl.tier)

    @property
    def has_demotions(self) -> bool:
        return any(not self.plan.is_fast(n) for n in self.plan.placements)

    # ------------------------------------------------------------ serving
    def host_table(self, name: str, table):
        """Wrap a demoted table in the row-granular serving facade (the
        int8 facade under ``embed_store='int8'``), behind a device-resident
        ``HotRowCache`` when ``cache_rows`` is set; pass a fast-tier table
        through unchanged."""
        if self._demoted_tier(name) is None:
            return table
        if isinstance(table, torch.Tensor):
            table = table.detach().cpu().numpy()
        if self.embed_store == "int8" and np.ndim(table) == 2:
            facade = QuantizedHostResident(table, self.device)
            self._int8[name] = facade
        else:
            facade = HostResident(table, self.device)
        if self.cache_rows > 0:
            from repro_torch.memory.cache import HotRowCache
            facade = HotRowCache(facade, self.cache_rows)
            self.caches[name] = facade
        return facade

    def prefetch_rows(self, name: str, ids) -> None:
        """Warm a serving table's hot-row cache with the given row ids
        (no-op for uncached tables)."""
        cache = self.caches.get(name)
        if cache is not None:
            cache.prefill(ids)

    def cache_stats(self) -> dict[str, dict]:
        """Per-table hit/miss/bytes-streamed counters for the serving
        caches this executor handed out."""
        return {name: c.stats.to_dict() for name, c in self.caches.items()}

    def store_nbytes(self, name: str) -> int | None:
        """Host-store bytes of an int8 table (q + scales), or None when the
        table is not int8-resident — what the planner's ``store_bytes``
        pricing should match."""
        facade = self._int8.get(name)
        return None if facade is None else facade.nbytes

    def describe(self) -> str:
        demoted = self.plan.demoted()
        store = f" embed_store=int8({len(self._int8)})" \
            if self.embed_store == "int8" else ""
        cache = ""
        if self.caches:
            parts = []
            for name, c in self.caches.items():
                s = c.stats
                parts.append(f"{name}: rows={c.rows} "
                             f"hit_rate={s.hit_rate:.2f} "
                             f"streamed={s.bytes_streamed}B")
            cache = f" cache[{'; '.join(parts)}]"
        return (f"TieredExecutor[{self.topology.name}] "
                f"demoted={len(demoted)} (host-store){store}{cache}")

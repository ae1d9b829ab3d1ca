"""TieredExecutor — makes a placement Plan functional (the port of
``repro/memory/executor.py``): ``place``/``fetch``/``commit`` for the
training state, and ``HostResident``, ``QuantizedHostResident`` and
``host_table`` for the serving tables.

**Host store only.**  PyTorch has no memory kinds, so the port always takes
the reference's *host-store path*.

Training: ``place`` copies every demoted ``params``/``opt`` leaf into a
host tensor — pinned when the pipeline's device is CUDA — and the state
carries that host tensor; fast-tier leaves go to the device.  Each step
``fetch`` issues one ``non_blocking`` host-to-device copy per demoted leaf
(one fetch serves every microbatch of the step: the tables do not change
inside one accumulated batch), and after the optimizer update ``commit``
copies each demoted leaf back into a fresh pinned host tensor.  The
executor keeps no reference to the device copies, so they free once the
step's state is dropped: between steps the demoted bytes are off the
card.  A fetched leaf holds the host leaf's bits and a committed leaf the
device leaf's, so a demoted fp32 run computes bit for bit what the
all-device run computes.

**Host reads after a commit.**  A ``non_blocking`` device-to-host copy into
pinned memory returns before it lands; the checkpoint writer,
``Run.params`` and ``Recommender.from_pipeline`` read those host tensors.
``commit`` (and ``place``) therefore end by synchronising the current
stream, so every host tensor the state carries has landed when the call
returns; the wait covers the step's update and copy-back, which the next
step's loss read waits for anyway.

Int8 store (``embed_store='int8'``): a demoted 2-D fp32 ``params`` table
is held as per-row int8 values plus one fp32 scale per row, quantized on
the leaf's own device by ``quantize_rows_int8_tensor`` (the bits of the
reference's numpy ``quantize_rows_int8``); the state carries the
dequantized fp32 view on the host, as the reference's does, and ``fetch``
ships the int8 rows and their scales and dequantizes on the card with one
IEEE multiply — the view's bits.  ``store_nbytes`` is the int8 store's
size.  ``link_bytes`` counts what ``fetch`` (``h2d``) and ``place``/
``commit`` (``d2h``) moved over the host link.

Serving: a table placed off the fast tier keeps its bytes in a CPU
tensor — pinned when the serving device is CUDA — and only the rows a
query needs cross the host link:

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
such a table there at all).  In training it likewise keeps a demoted
leaf as a device array in that memory kind, with no host store and no
int8 buffers.  Facade and leaf types, cache counters, ``store_nbytes``
and host-store trajectories are comparable only on topologies whose tiers
have ``memory_kind=None`` (``uniform``, ``dram-optane-*``); on
``tpu-hbm-host`` the port's results are held against the reference's
all-fast placement, since placement never changes results, while plans
and ``describe()`` lines compare on every topology.  A parity test that
compares host-store behaviour must never use ``tpu-hbm-host``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.memory.policies import Plan
from repro_torch.optim.compression import (dequantize_rows_int8,
                                           quantize_rows_int8,
                                           quantize_rows_int8_tensor)
from repro_torch.optim.optimizers import tree_map_with_path
from repro_torch import trace


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

    @classmethod
    def from_rows(cls, q: torch.Tensor, scale: torch.Tensor,
                  device) -> "QuantizedHostResident":
        """The store over rows quantized already: ``q`` [N, D] int8 and
        ``scale`` [N, 1] float32, host tensors."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.q, self.scale = q, scale
        self._shape = tuple(q.shape)
        self.link_bytes = 0
        return self

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
    """Drives one Plan's placements: every leaf or table placed off the
    fast tier goes to the host store."""

    # the training state's subtrees the executor places; others (the
    # compressor's "comp") stay where they are
    prefixes = ("params", "opt")

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
        # host-store leaves currently demoted (by profile name)
        self._host_names: set[str] = set()
        # int8 host stores: name -> the quantized facade
        self._int8: dict[str, QuantizedHostResident] = {}
        # bytes fetch (h2d) and place/commit (d2h) moved over the host link
        self.link_bytes = {"h2d": 0, "d2h": 0}

    # ------------------------------------------------------------ queries
    def _demoted_tier(self, name: str):
        pl = self.plan.placements.get(name)
        if pl is None or pl.tier == self.topology.fast.name:
            return None
        return self.topology.tier(pl.tier)

    @property
    def has_demotions(self) -> bool:
        return any(not self.plan.is_fast(n) for n in self.plan.placements)

    @property
    def _crosses(self) -> bool:
        """Whether the host store and the compute device are apart."""
        return self.device.type == "cuda"

    def _walk(self, state, leaf_fn):
        """``leaf_fn(name, leaf)`` over the ``prefixes`` subtrees, named as
        the planner's profiles are; other entries pass through."""
        out = dict(state)
        for prefix in self.prefixes:
            out[prefix] = tree_map_with_path(
                lambda path, leaf, p=prefix: leaf_fn(p + path, leaf),
                state[prefix])
        return out

    def _wants_int8(self, name: str, leaf) -> bool:
        """Embedding tables demoted to the host store are the quantized
        arm: 2-D float32 ``params`` leaves (tables), when the executor
        runs with ``embed_store='int8'``."""
        return (self.embed_store == "int8"
                and name.startswith("params")
                and isinstance(leaf, torch.Tensor) and leaf.dim() == 2
                and leaf.dtype == torch.float32)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a host tensor, pinned when the device is CUDA: one
        ``non_blocking`` copy into a fresh pinned tensor for a device
        tensor (it lands by the stream synchronisation in ``_landed``)."""
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            self.link_bytes["d2h"] += t.numel() * t.element_size()
            return buf
        if self._crosses and not t.is_pinned():
            return t.pin_memory()
        return t

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if self._crosses:
            self.link_bytes["h2d"] += t.numel() * t.element_size()
        return t.to(self.device, non_blocking=True)

    def _landed(self) -> None:
        """Wait until the device-to-host copies issued so far have landed
        (see the module docstring: host readers follow)."""
        if self._crosses:
            with trace.host_wait("landed"):
                torch.cuda.current_stream(self.device).synchronize()

    def _store(self, name: str, leaf):
        """Commit one host-store leaf: quantized tables keep (int8, scale)
        rows and the state carries the dequantized fp32 view; everything
        else stores its own bytes."""
        if self._wants_int8(name, leaf):
            q, scale = quantize_rows_int8_tensor(leaf)
            view = q.to(torch.float32) * scale
            self._int8[name] = QuantizedHostResident.from_rows(
                self._to_host(q), self._to_host(scale), self.device)
            return self._to_host(view)
        self._int8.pop(name, None)
        return self._to_host(leaf)

    # ------------------------------------------------------------ placement
    def place(self, state) -> tuple[object, int]:
        """Move every demoted state leaf into the host store and every
        other leaf to the device.  Returns (state, n_offloaded)."""
        self._host_names.clear()
        self._int8.clear()
        moved = 0

        def place_leaf(name, leaf):
            nonlocal moved
            if self._demoted_tier(name) is None:
                return leaf.to(self.device)
            moved += 1
            self._host_names.add(name)
            return self._store(name, leaf)

        out = self._walk(state, place_leaf)
        self._landed()
        return out, moved

    # ------------------------------------------------------------ streaming
    def fetch(self, state):
        """Demoted host-store leaves -> device (asynchronous copies; the
        returned state is the only holder of the device copies).  An int8
        table ships its rows and scales and dequantizes on the device.
        Identity when nothing is demoted, or when the device is the host."""
        if not self._host_names or not self._crosses:
            return state

        def up(name, leaf):
            if name not in self._host_names:
                return leaf
            store = self._int8.get(name)
            if store is None:
                return self._to_device(leaf)
            return self._to_device(store.q).to(torch.float32) \
                * self._to_device(store.scale)

        return self._walk(state, up)

    def commit(self, state):
        """Write demoted leaves' updated bytes back to the host store
        (quantized tables re-quantize here, so the carried state is always
        the int8 round trip), then wait for the copies to land.  Identity
        when nothing is host-resident."""
        if not self._host_names:
            return state
        out = self._walk(
            state, lambda name, leaf:
            self._store(name, leaf) if name in self._host_names else leaf)
        self._landed()
        return out

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

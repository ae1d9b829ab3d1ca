"""ShardPlan — the sharded execution contract of one training run (the port
of ``repro/pipeline/shard.py``).

One process per shard, in ``torch.distributed``'s idiom: P ranks of one
process group (NCCL on the card, gloo on the CPU), each holding 1/P of
every row-sharded table and its optimizer moments.  The group comes from
the caller (``dist.init_process_group`` with a store of its own, e.g. a
``FileStore``) or from ``torchrun``'s environment; a live plan whose shard
count differs from the world size raises.  One ``ShardPlan`` flows through
the layers as in the reference:

  * ``pipeline.sparse``   — aggregation through the ring SpMM
    (``dist.ring_spmm``) when ``wants_ring``: the unified node space (users
    then items) is cut into P row blocks, edges are bucketed by (dst rank,
    ring distance to the src rank), and each ring step is one ``spmm_csr``
    over a bucket while the next block arrives;
  * ``pipeline.plan``     — per-rank profiles: a row-sharded leaf counts
    1/P against the rank's budget, and the derived microbatch is the
    per-shard one (global batch = P x microbatch x accum);
  * ``pipeline.engine``   — every rank draws the same global batch, takes
    its own rows of each chunk, all-reduces the loss and the gradients of
    replicated leaves, and reduce-scatters those of row-sharded leaves to
    their owners;
  * ``eval.topk``         — the streaming top-K splits each user batch
    over the ranks and all-gathers the merged rows.

The table layout and the ring's differ: a table is row-sharded over its
own rows, the ring over the unified node space, so the forward gathers
the full tables (``dist.collectives.gather_rows``, whose backward
reduce-scatters) and the ring slices its block out of them.  The
single-device plan (``shape=(1,)`` and no explicit spmm) is inert:
``from_config`` returns None and the unsharded path runs.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.optim.optimizers import tree_map


def auto_axes(shape) -> tuple[str, ...]:
    """Default axis names for a mesh shape: every axis is data-parallel, so
    the names only need to be unique and recognizable."""
    n = len(tuple(shape))
    if n == 1:
        return ("data",)
    if n == 2:
        return ("pod", "data")
    return tuple(f"data{i}" for i in range(n))


@dataclasses.dataclass(frozen=True)
class NodePartition:
    """Block partition of ``n_nodes`` rows over ``n_shards`` ranks, padded so
    every rank owns the same number of rows.  Padded rows carry no edges,
    so sharded aggregation leaves them zero and callers slice them off
    (``trim``)."""
    n_nodes: int
    n_shards: int

    @property
    def n_pad(self) -> int:
        """Node count rounded up to the next multiple of the shard count."""
        return math.ceil(self.n_nodes / self.n_shards) * self.n_shards

    @property
    def n_local(self) -> int:
        return self.n_pad // self.n_shards

    def pad_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[n_nodes, D] -> [n_pad, D], zero rows appended."""
        return F.pad(x, (0, 0, 0, self.n_pad - self.n_nodes))

    def trim(self, x: torch.Tensor) -> torch.Tensor:
        """[n_pad, D] -> [n_nodes, D]: the padded rows sliced back off."""
        return x if self.n_pad == self.n_nodes else x[:self.n_nodes]

    def block(self, x: torch.Tensor, rank: int,
              offset: int = 0) -> torch.Tensor:
        """Rank ``rank``'s block [n_local, D] of the padded unified rows,
        where ``x`` holds unified rows [offset, offset + len(x)) and every
        other row is zero (a table lifted into the unified space)."""
        lo, hi = rank * self.n_local, (rank + 1) * self.n_local
        a = min(max(lo, offset), hi)
        b = max(min(hi, offset + x.shape[0]), a)
        return F.pad(x[a - offset:b - offset], (0, 0, a - lo, hi - b))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Mesh shape/axes + SpMM dispatch + ring band for one run.

    ``spmm``: ``None`` = auto (ring when the mesh has >1 shard, the plain
    kernel dispatch otherwise); ``"ring"`` forces the ring path even on
    one shard (the degenerate ring: one bucket, no rotation).
    """
    shape: tuple[int, ...] = (1,)
    axes: tuple[str, ...] = ("data",)
    spmm: str | None = None          # None (auto) | 'ring'
    ring_steps: int | None = None    # banded ring: visit only n_steps owners
    ring_quant: bool = False         # int8 ring payload rotation
    #                                  (CompressionCfg.ring = 'int8')

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axes", tuple(str(a) for a in self.axes))
        object.__setattr__(self, "ring_quant", bool(self.ring_quant))
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} has "
                             f"{len(self.shape)} dims but axes {self.axes} "
                             f"name {len(self.axes)}")
        if self.spmm not in (None, "ring"):
            raise ValueError(f"unknown spmm dispatch {self.spmm!r}; "
                             "known: None (auto), 'ring'")
        if self.ring_steps is not None and self.ring_steps < 1:
            raise ValueError(f"ring_steps must be >= 1 (or None for the "
                             f"full ring), got {self.ring_steps}")

    # ------------------------------------------------------------ shape
    @property
    def n_shards(self) -> int:
        return int(np.prod(self.shape))

    @property
    def is_sharded(self) -> bool:
        return self.n_shards > 1

    @property
    def wants_ring(self) -> bool:
        """Route aggregation through ``dist.ring_spmm``?"""
        return self.spmm == "ring" or (self.spmm is None and self.is_sharded)

    @property
    def dp(self):
        """The data-parallel axis name (one name or a tuple), carried by
        ``dist.hints.sharding_hints``."""
        return self.axes if len(self.axes) > 1 else self.axes[0]

    def partition(self, n_nodes: int) -> NodePartition:
        return NodePartition(int(n_nodes), self.n_shards)

    # ------------------------------------------------------------ group
    def process_group(self, device):
        """The process group of the plan's P ranks (the reference's
        ``build_mesh``): the default group the caller opened, or one opened
        from ``torchrun``'s environment; None for one shard with no group
        open (every collective is then the identity).  Raises ValueError
        when the world size is not P or the backend does not serve
        ``device`` (NCCL for the card, gloo for the CPU)."""
        want = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            if want == "nccl":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(want)
        if not dist.is_initialized():
            if self.n_shards == 1:
                return None
            world = 1
        else:
            world = dist.get_world_size()
        if world != self.n_shards:
            raise ValueError(
                f"mesh shape {self.shape} needs {self.n_shards} processes "
                f"but the world size is {world}; launch one process per "
                f"shard, e.g. torchrun --nproc-per-node {self.n_shards}")
        backend = dist.get_backend()
        if backend != want:
            raise ValueError(f"a {torch.device(device).type} run needs a "
                             f"{want} process group; this one is {backend}")
        return dist.group.WORLD

    # ------------------------------------------------------------ placement
    def shard_batch(self, *arrays, rank: int):
        """This rank's rows of a global batch chunk: [r·mu, (r+1)·mu) with
        mu = ceil(rows / P) (the per-shard microbatch for a full chunk)."""
        out = []
        for a in arrays:
            mu = math.ceil(len(a) / self.n_shards)
            out.append(a[rank * mu:(rank + 1) * mu])
        return tuple(out) if len(out) > 1 else out[0]

    def shard_divisor(self, leaf_shape) -> int:
        """How many ways a tensor of this shape is split per rank — the
        planner divides its bytes by this (per-rank profiling)."""
        if not self.is_sharded:
            return 1
        if len(leaf_shape) >= 2 and leaf_shape[0] % self.n_shards == 0:
            return self.n_shards
        return 1

    def shard_state(self, tree, rank: int):
        """This rank's part of a whole state: a copy of its row block of
        every leaf with >= 2 dims and a leading dim divisible by P (nothing
        of the whole leaf stays alive), every other leaf whole (replicated).
        Identity on one shard."""
        if not self.is_sharded:
            return tree

        def block(leaf):
            p = self.shard_divisor(tuple(leaf.shape))
            if p == 1:
                return leaf
            n = leaf.shape[0] // p
            return leaf[rank * n:(rank + 1) * n].clone()

        return tree_map(block, tree)

    def describe(self) -> str:
        band = f" ring_steps={self.ring_steps}" if self.ring_steps else ""
        quant = " ring_quant=int8" if self.ring_quant else ""
        return (f"mesh={'x'.join(map(str, self.shape))} "
                f"axes={','.join(self.axes)} "
                f"spmm={'ring' if self.wants_ring else 'kernel'}{band}{quant}")

    # ------------------------------------------------------------ builders
    @classmethod
    def from_config(cls, mesh_shape=(1,), mesh_axes=None, spmm=None,
                    ring_steps=None, ring_quant=False) -> "ShardPlan | None":
        """The engine-facing constructor: ``None`` for the inert
        single-device default, a live plan otherwise."""
        shape = tuple(int(s) for s in mesh_shape)
        axes = tuple(mesh_axes) if mesh_axes else auto_axes(shape)
        plan = cls(shape, axes, spmm, ring_steps, ring_quant)
        if not plan.is_sharded and not plan.wants_ring:
            return None
        return plan


def parse_mesh(text: str) -> tuple[int, ...]:
    """'4' -> (4,); '2x2' -> (2, 2) — the --mesh CLI syntax."""
    try:
        return tuple(int(t) for t in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {text!r}; expected e.g. '4' or "
                         "'2x2'") from None

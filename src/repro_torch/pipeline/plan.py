"""TrainPlan — the placement and batching contract of one training run
(the port of ``repro/pipeline/plan.py``).

The placement policy decides which tensors keep fast-tier residency, and
the fast-tier capacity left over bounds the microbatch; the 150K-sample
target batches of §7.1 then run as ``ceil(B/microbatch)`` accumulated
microbatches.  ``build_train_plan`` profiles the run's actual tensor set
(every params/optimizer leaf by its real bytes, the CSR adjacency, and —
only for models that form them — the per-layer edge-message matrices),
runs the selected ``repro_torch.memory`` placement policy over the
selected ``TierTopology``, and derives the microbatch.  Budgets are per
tier and, under a ``ShardPlan``, per shard: the profiles describe one
rank's part (a row-sharded leaf counts 1/P, the ring buckets 1/P, the
materialised messages 1/P) and the derived microbatch is the per-shard
one.  The planner's numbers equal the reference's on the same state.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.large_batch import LargeBatchSchedule
from repro_torch.memory import (AccessProfile, Plan, TieredExecutor,
                                get_policy, get_topology,
                                quantized_table_bytes)
from repro_torch.optim.optimizers import tree_paths


def _leaf_profiles(tree, prefix: str, reads: float, writes: float,
                   shard=None,
                   embed_store: str = "fp32") -> list[AccessProfile]:
    """One AccessProfile per leaf with bytes, named ``prefix`` + the leaf's
    ``jax.tree_util.keystr`` path (``params['user_embed']``,
    ``opt['m']['w1'][0]``, ``opt['t']``), as the reference names them:
    pins match these names by substring.  ``tree`` holds whole leaves;
    under ``shard`` each counts its bytes per shard."""
    out = []
    for path, leaf in tree_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        itemsize = leaf.element_size()
        nbytes = leaf.numel() * itemsize
        if nbytes == 0:
            continue
        if shard is not None:
            nbytes //= shard.shard_divisor(tuple(leaf.shape))
        row = (leaf.shape[-1] if leaf.dim() else 1) * itemsize
        # int8 capacity-tier storage: 2-D fp32 params tables carry their
        # quantized footprint (1 B/element + one fp32 scale per row) —
        # the leaves TieredExecutor._wants_int8 quantizes
        store = quantized_table_bytes(max(nbytes // row, 1), row) \
            if (embed_store == "int8" and prefix == "params"
                and leaf.dim() == 2 and leaf.dtype == torch.float32) \
            else None
        out.append(AccessProfile(prefix + path, nbytes,
                                 reads_per_step=reads,
                                 writes_per_step=writes, access_size=row,
                                 store_bytes=store))
    return out


def profiles_from_state(params, opt_state, g, n_layers: int, spec,
                        embed_dim: int, shard=None,
                        embed_store: str = "fp32") -> list[AccessProfile]:
    """AccessProfiles over the run's actual tensor set (paper §2.1 memory
    model, measured from the live state instead of assumed shapes).  With
    a live ``ShardPlan`` every profile describes one shard's part."""
    p = shard.n_shards if shard is not None else 1
    profs = []
    # embedding tables + weights: read every layer fwd+bwd, written once
    profs += _leaf_profiles(params, "params", reads=2.0 * n_layers,
                            writes=1.0, shard=shard,
                            embed_store=embed_store)
    # optimizer state: one read + one write per update
    profs += _leaf_profiles(opt_state, "opt", reads=1.0, writes=1.0,
                            shard=shard)
    # adjacency: read-only, tiny access granularity (the reference's byte
    # count, BipartiteCSR.graph_nbytes).  Per shard: the CSR stays whole
    # (edge aggregations and evaluation read it) while the ring buckets
    # are dst-sharded at 1/P each
    if shard is None:
        gbytes = g.graph_nbytes()
    else:
        gbytes = g.csr_nbytes() + max(g.ring_nbytes() // p, 1)
    profs.append(AccessProfile("graph/csr", gbytes,
                               reads_per_step=2.0 * n_layers,
                               writes_per_step=0.0, access_size=8))
    if spec.messages_materialized(g):
        # per-layer messages are layer-input wide ([E, embed_dim]) even
        # when the model concatenates layer outputs; a shard forms its
        # edge partition's share.  The fused Hadamard route never forms
        # them: no profile, and the microbatch derives against the
        # reclaimed budget
        row = embed_dim * 4
        for l in range(n_layers):
            profs.append(AccessProfile(
                f"messages_l{l}", max(g.n_edges * row // p, row),
                reads_per_step=2.0, writes_per_step=2.0, access_size=row))
    return profs


def derive_microbatch(free_hbm: int, out_dim: int, target_batch: int,
                      floor: int = 32) -> int:
    """Largest power-of-two microbatch whose per-sample working set fits
    the device memory left after placement.  Per BPR sample: 3 embedding
    rows (u, i+, i-) x forward/backward activations + temporaries
    (~8 row-equivalents)."""
    bytes_per_sample = 3 * out_dim * 4 * 8
    mu = max(int(free_hbm) // bytes_per_sample, floor)
    mu = 1 << (mu.bit_length() - 1)          # power-of-two floor
    return int(min(mu, target_batch))


def derive_eval_batch(free_hbm: int, out_dim: int, k: int, item_block: int,
                      floor: int = 32, cap: int = 4096) -> int:
    """Largest power-of-two user microbatch for streaming eval/serving:
    per user the carry, one score block, and the concat double-buffer —
    ``(K + 2·block + D) · 4B`` — must fit the device memory left after
    placement."""
    per_user = (k + 2 * item_block + out_dim) * 4
    b = max(int(free_hbm) // max(per_user, 1), floor)
    b = 1 << (b.bit_length() - 1)            # power-of-two floor
    return int(min(b, cap))


def serving_profiles(user_nbytes: int, item_nbytes: int, row: int,
                     user_fraction: float = 0.05,
                     cache_rows: int = 0,
                     ann_index_bytes: int = 0) -> list[AccessProfile]:
    """AccessProfiles for the serving snapshot: every query batch streams
    the full item table block-by-block (read 1.0×/step), but gathers only
    the batch's rows of the user table (``user_fraction``×/step) — so
    under a tight budget the planner demotes the user table first.

    ``cache_rows`` prices the hot-row cache's device slots against the
    fast tier (a pinned-fast reservation: slot store + per-slot
    bookkeeping, priced at 2 rows/slot) — the knapsack sees the cache
    budget as spent and may demote a table the cache then serves.

    ``ann_index_bytes`` prices the ANN index's coarse summaries
    (``serving.ann.ann_index_nbytes``) the same way: pinned fast, because
    the coarse stage runs on every query batch and exists to avoid
    touching the slow tier."""
    profs = [
        AccessProfile("serve/user_embed", int(user_nbytes),
                      reads_per_step=user_fraction, writes_per_step=0.0,
                      access_size=row),
        AccessProfile("serve/item_embed", int(item_nbytes),
                      reads_per_step=1.0, writes_per_step=0.0,
                      access_size=row),
    ]
    if cache_rows > 0:
        profs.append(AccessProfile("serve/hot_cache",
                                   int(2 * cache_rows * row),
                                   reads_per_step=0.0, writes_per_step=0.0,
                                   access_size=row, pinned="fast"))
    if ann_index_bytes > 0:
        profs.append(AccessProfile("serve/ann_index", int(ann_index_bytes),
                                   reads_per_step=1.0, writes_per_step=0.0,
                                   access_size=row, pinned="fast"))
    return profs


@dataclasses.dataclass
class TrainPlan:
    """Everything the engine needs to run one training configuration.

    ``impl`` names the port's kernel route (``torch`` or ``cuda``).
    ``microbatch`` is the per-shard microbatch: each of the ``shards``
    ranks runs that many samples per accumulation chunk, so the global
    batch is ``shards x microbatch x accum`` (``global_microbatch`` per
    chunk).  ``hbm_budget`` is the fast-tier budget (per shard); the full
    per-tier budgets live on ``plan.budgets``."""
    arch: str
    plan: Plan                     # tier placement over the tensor set
    sched: LargeBatchSchedule
    microbatch: int                # per shard
    impl: str                      # kernel route ('torch' | 'cuda')
    hbm_budget: int                # fast-tier budget, per shard
    shards: int = 1                # mesh size P

    @property
    def global_microbatch(self) -> int:
        return self.microbatch * self.shards

    @property
    def topology(self):
        return self.plan.topology

    @property
    def write_policy(self) -> dict[str, str]:
        """Per-kernel §6 write-policy table, emitted from the plan."""
        return self.plan.write_policy()

    def microbatches_for_epoch(self, epoch: int) -> int:
        return max(1, math.ceil(self.sched.batch_for_epoch(epoch)
                                / self.global_microbatch))

    def describe(self) -> str:
        tiers = {}
        for name, p in self.plan.placements.items():
            tiers.setdefault(p.tier, []).append(name)
        shard_txt = f" shards={self.shards}" if self.shards > 1 else ""
        fast = self.topology.fast.name
        lines = [f"TrainPlan[{self.arch}] impl={self.impl}{shard_txt} "
                 f"microbatch={self.microbatch} "
                 f"target_batch={self.sched.target_batch} "
                 f"topology={self.topology.name} policy={self.plan.policy} "
                 f"{fast}={self.plan.hbm_used/2**20:.1f}/"
                 f"{self.hbm_budget/2**20:.1f} MiB "
                 f"est_penalty={self.plan.est_step_penalty_s*1e3:.2f} ms/step"]
        for tier in self.topology.names:
            names = tiers.get(tier, [])
            if names:
                lines.append(f"  {tier}: {', '.join(sorted(names))}")
        wp = self.write_policy
        lines.append("  write_policy: "
                     + " ".join(f"{k}={wp[k]}" for k in sorted(wp)))
        return "\n".join(lines)


def build_train_plan(arch: str, spec, params, opt_state, g, n_layers: int,
                     embed_dim: int, sched: LargeBatchSchedule, impl: str,
                     hbm_budget: int | None = None,
                     microbatch: int | None = None,
                     shard=None,
                     topology: "str | object" = "tpu-hbm-host",
                     policy: str = "greedy",
                     pins: dict | None = None,
                     embed_store: str = "fp32") -> TrainPlan:
    """Profile -> place -> derive the microbatch.  ``topology`` names a
    registered ``TierTopology`` (or is one); ``policy`` names a registered
    placement policy; ``pins`` force tensors onto tiers by (sub)name.
    ``hbm_budget`` overrides the fast tier's capacity; all budgets are per
    shard, and with a ``ShardPlan`` the derived microbatch is the
    per-shard one."""
    topo = get_topology(topology)
    budgets = topo.capacities()
    if hbm_budget is not None:
        budgets[topo.fast.name] = int(hbm_budget)
    budget = budgets[topo.fast.name]
    profs = profiles_from_state(params, opt_state, g, n_layers, spec,
                                embed_dim, shard=shard,
                                embed_store=embed_store)
    plan = get_policy(policy)(profs, topo, budgets=budgets, pins=pins)
    shards = shard.n_shards if shard is not None else 1
    if microbatch is None:
        microbatch = derive_microbatch(budget - plan.hbm_used,
                                       spec.out_dim(embed_dim, n_layers),
                                       max(1, sched.target_batch // shards))
    return TrainPlan(arch, plan, sched, int(microbatch), impl, budget,
                     shards=shards)


# ---------------------------------------------------------------- placement
def host_offload_sharding():
    """The reference's sharding onto the host memory kind.  PyTorch has no
    memory kinds, so there is none: None, as the reference returns on
    backends without them (a demoted leaf then goes to the executor's
    host store)."""
    return None


def apply_placements(state, plan: Plan, device="cuda") -> tuple[object, int]:
    """Place every state leaf onto its planned tier.  Returns
    (state, n_offloaded).  A thin wrapper: the engine drives a
    ``repro_torch.memory.TieredExecutor`` directly."""
    return TieredExecutor(plan, device=device).place(state)

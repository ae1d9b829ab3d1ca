"""PlacementPolicy — pluggable tensor→tier assignment over a topology (the
port of ``repro/memory/policies.py``; plans are equal to the reference's
on the same profiles).

The paper solved placement by hand per kernel (AppDirect + numactl,
§6); §8.1 points at AutoTM's ILP as the automated future.  This module
ships both, behind one registry so the planner, benchmarks, and tests
select policies *by name*:

  ``greedy``        density-ordered knapsack (penalty-per-byte), the
                    production default; auto-certifies itself through
                    the exact DP when the free-tensor count is small.
  ``exact``         0/1-knapsack DP (AutoTM-style) — optimal for small
                    tensor counts, used to certify the greedy plan.
  ``paper-recipe``  the paper's §6 hand recipe as pins: the |E|-sized
                    graph structure and SDDMM message streams take the
                    capacity tier (nt-written, per the emitted write
                    policy) along with the once-per-step optimizer
                    state, while the embedding tables keep fast-tier
                    residency; the rest falls back to greedy.
  ``all-fast`` / ``all-slow``   what-if baselines (Fig 10's
                    Optane-alone arm; capacity is reported, not
                    enforced).

A policy is ``(profiles, topology, *, budgets=None, pins=None) ->
Plan``.  ``pins`` maps a profile name (exact, or substring — e.g. the
dotted-path ``params['item_embed']`` or just ``item_embed``) to a tier
name or the ``fast``/``slow`` aliases; pins override the profiles' own
``pinned`` fields.

Tensors pinned to a slow tier contribute their *real* step penalty to ``est_step_penalty_s`` — a
paper-recipe plan reports what its pins actually cost.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Mapping, Protocol

from repro_torch.memory.profiles import AccessProfile
from repro_torch.memory.topology import (TierTopology, get_topology,
                                         resolve_tier)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One tensor's assignment: the tier it lives on and the step-time
    penalty actually incurred there (0.0 on the fast tier — including
    for pinned tensors, whose slow-tier penalties are real and counted)."""
    tier: str
    penalty_s: float
    pinned: bool = False


@dataclasses.dataclass
class Plan:
    """A complete placement over one topology."""
    placements: dict[str, Placement]
    used: dict[str, int]             # bytes resident per tier
    budgets: dict[str, int]          # capacity per tier
    est_step_penalty_s: float        # total slow-tier penalty incurred
    topology: TierTopology
    policy: str = "greedy"

    # ------------------------------------------------------------ queries
    def tier(self, name: str) -> str:
        return self.placements[name].tier

    def is_fast(self, name: str) -> bool:
        return self.placements[name].tier == self.topology.fast.name

    def memory_kind(self, name: str) -> str | None:
        return self.topology.tier(self.tier(name)).memory_kind

    def demoted(self) -> list[str]:
        """Names placed off the fast tier, sorted."""
        return sorted(n for n in self.placements if not self.is_fast(n))

    # ------------------------------------------------------------ legacy view
    @property
    def hbm_used(self) -> int:
        """Fast-tier bytes (legacy name from the two-tier TPU planner)."""
        return self.used[self.topology.fast.name]

    @property
    def hbm_budget(self) -> int:
        return self.budgets[self.topology.fast.name]

    # ------------------------------------------------------------ §6 table
    def write_policy(self) -> dict[str, str]:
        """The per-kernel write-policy table, emitted from the plan
        (paper §6): SDDMM streams its edge-message output (nt-write
        analogue — no accumulator) whenever the topology has write
        asymmetry to route around or a message tensor actually lands
        off the fast tier; SpMM and embedding_bag always accumulate in
        fast memory (nt-write destroys them, paper Fig 9)."""
        msgs_demoted = any("messages" in n and not self.is_fast(n)
                           for n in self.placements)
        sddmm = "streaming" if (msgs_demoted or not self.topology.is_uniform) \
            else "accumulate"
        return {"sddmm": sddmm, "spmm": "accumulate",
                "embedding_bag": "accumulate"}

    # ------------------------------------------------------------ snapshot
    def to_dict(self) -> dict:
        """Deterministic JSON form."""
        return {
            "topology": self.topology.name,
            "policy": self.policy,
            "placements": {n: self.placements[n].tier
                           for n in sorted(self.placements)},
            "used": {k: int(v) for k, v in sorted(self.used.items())},
            "budgets": {k: int(v) for k, v in sorted(self.budgets.items())},
            "est_step_penalty_s": round(float(self.est_step_penalty_s), 9),
            "write_policy": self.write_policy(),
        }


class PlacementPolicy(Protocol):
    def __call__(self, profiles: Iterable[AccessProfile],
                 topology: TierTopology | str, *,
                 budgets: Mapping[str, int] | None = None,
                 pins: Mapping[str, str] | None = None) -> Plan: ...


# ---------------------------------------------------------------- helpers
def _bytes_on(p: AccessProfile, topology: TierTopology, tier: str) -> int:
    """Resident bytes of ``p`` on ``tier``: quantized ``store_bytes``
    off the fast tier (int8 capacity-tier tables at ~1/4 bytes), dense
    ``nbytes`` on it — the quantity every budget/usage account uses."""
    return p.bytes_on(tier == topology.fast.name)


def _budgets(topology: TierTopology,
             overrides: Mapping[str, int] | None) -> dict[str, int]:
    out = topology.capacities()
    for name, cap in (overrides or {}).items():
        if name not in out:
            raise KeyError(f"no tier {name!r} in topology "
                           f"{topology.name!r} to budget")
        out[name] = int(cap)
    return out


def _effective_pin(p: AccessProfile, topology: TierTopology,
                   pins: Mapping[str, str] | None) -> str | None:
    """The tier this profile is pinned to, if any: an entry in ``pins``
    (exact name match wins over substring matches, which are resolved
    in sorted-pattern order) overrides the profile's own ``pinned``."""
    label = None
    if pins:
        if p.name in pins:
            label = pins[p.name]
        else:
            for pat in sorted(pins):
                if pat in p.name:
                    label = pins[pat]
                    break
    if label is None:
        label = p.pinned
    return resolve_tier(topology, label) if label is not None else None


def _place_pinned(profiles, topology, budgets, pins):
    """Shared pinned-first pass: returns (placements, used, free,
    pinned_penalty).  Pinned slow-tier tensors carry their real penalty."""
    placements: dict[str, Placement] = {}
    used = {t.name: 0 for t in topology.tiers}
    free: list[AccessProfile] = []
    pinned_penalty = 0.0
    for p in profiles:
        tier = _effective_pin(p, topology, pins)
        if tier is None:
            free.append(p)
            continue
        pen = topology.demotion_penalty(p, tier)
        placements[p.name] = Placement(tier, pen, pinned=True)
        used[tier] += _bytes_on(p, topology, tier)
        pinned_penalty += pen
    fast = topology.fast.name
    if used[fast] > budgets[fast]:
        raise MemoryError(
            f"pinned tensors ({used[fast]/2**30:.1f} GiB) exceed "
            f"{fast} budget ({budgets[fast]/2**30:.1f} GiB)")
    return placements, used, free, pinned_penalty


# ---------------------------------------------------------------- policies
def place_greedy(profiles, topology, *, budgets=None, pins=None,
                 exact_threshold: int = 16) -> Plan:
    """Density-ordered knapsack: keep the highest penalty-per-byte
    tensors on the fast tier until its budget runs out, waterfall the
    rest down the tier order.  Optimal here because cost is additive
    and the only constraint is capacity (a fractional knapsack rounded
    down); when the free-tensor count is small and the topology has two
    tiers, the exact DP answers instead (self-certifying)."""
    topology = get_topology(topology)
    budgets = _budgets(topology, budgets)
    profiles = list(profiles)
    n_free = sum(1 for p in profiles
                 if _effective_pin(p, topology, pins) is None)
    if 0 < n_free <= exact_threshold and len(topology.tiers) == 2:
        plan = place_exact(profiles, topology, budgets=budgets, pins=pins)
        for t in topology.tiers[1:]:
            if plan.used[t.name] > budgets[t.name]:
                raise MemoryError(f"{t.name} tier over budget")
        return dataclasses.replace(plan, policy="greedy")
    placements, used, free, penalty = _place_pinned(
        profiles, topology, budgets, pins)
    for t in topology.tiers[1:]:
        if used[t.name] > budgets[t.name]:
            raise MemoryError(f"pinned tensors over {t.name} budget")
    ranked = sorted(
        free, key=lambda p: -topology.demotion_penalty(p) / max(p.nbytes, 1))
    for p in ranked:
        for t in topology.tiers:
            size = _bytes_on(p, topology, t.name)
            if used[t.name] + size <= budgets[t.name]:
                pen = topology.demotion_penalty(p, t)
                placements[p.name] = Placement(t.name, pen)
                used[t.name] += size
                penalty += pen
                break
        else:
            raise MemoryError(f"tensor {p.name} fits no tier")
    return Plan(placements, used, budgets, penalty, topology,
                policy="greedy")


def place_exact(profiles, topology, *, budgets=None, pins=None) -> Plan:
    """Exact 0/1-knapsack DP (small tensor counts, two-tier topologies
    only) — the AutoTM-style ILP answer, used to certify greedy plans.
    The pinned fast-tier size is computed once, outside the 2^n subset
    loop."""
    topology = get_topology(topology)
    if len(topology.tiers) != 2:
        raise ValueError("exact planner supports two-tier topologies; "
                         f"{topology.name!r} has {len(topology.tiers)}")
    budgets = _budgets(topology, budgets)
    profiles = list(profiles)
    placements, used, free, penalty = _place_pinned(
        profiles, topology, budgets, pins)
    if len(free) > 24:
        raise ValueError("exact planner is for small tensor counts")
    fast, slow = topology.fast.name, topology.slow.name
    pinned_fast = used[fast]                # hoisted: loop-invariant
    budget = budgets[fast]
    # best = (value, kept_bytes, keep): penalty-value first, then —
    # among equal-value subsets — the one keeping MORE bytes fast, so
    # zero-penalty topologies (uniform) never demote gratuitously and
    # the DP agrees with greedy's fill-fast-first behaviour on ties.
    best_keep: tuple[float, int, tuple[int, ...]] = (-1.0, -1, ())
    for keep in itertools.product([0, 1], repeat=len(free)):
        size = sum(p.nbytes for p, k in zip(free, keep) if k)
        if size + pinned_fast > budget:
            continue
        value = sum(topology.demotion_penalty(p)
                    for p, k in zip(free, keep) if k)
        if (value, size) > (best_keep[0], best_keep[1]):
            best_keep = (value, size, keep)
    if not free:
        best_keep = (0.0, 0, ())
    elif best_keep[0] < 0.0:
        raise MemoryError("pinned tensors leave no room on the fast tier")
    for p, k in zip(free, best_keep[2]):
        if k:
            placements[p.name] = Placement(fast, 0.0)
            used[fast] += p.nbytes
        else:
            pen = topology.demotion_penalty(p)
            placements[p.name] = Placement(slow, pen)
            used[slow] += _bytes_on(p, topology, slow)
            penalty += pen
    return Plan(placements, used, budgets, penalty, topology,
                policy="exact")


# Paper §6 recipe, as name-pattern pins over the live tensor names
# (both the planner's params[...]/opt[...]/graph/messages_l* names and
# the analytic gnn_recsys_profiles names): everything |E|-sized lives
# on the capacity tier — the graph structure because it is read-only,
# the SDDMM message streams because only that tier can hold them (the
# nt-write/streaming policy the plan emits is what makes those writes
# survivable, §6) — while the node-sized embedding tables keep
# fast-tier residency; optimizer state is touched once per step.
_PAPER_RECIPE_PINS = (
    ("graph", "slow"),       # read-only structure: Optane holds it
    ("messages", "slow"),    # |E|-sized SDDMM streams: nt-written to PM
    ("opt", "slow"),         # optimizer state: one touch per step
    ("embed", "fast"),       # embedding tables: row-granular hot reads
)


def place_paper_recipe(profiles, topology, *, budgets=None,
                       pins=None) -> Plan:
    """The paper's §5-§6 hand-tuned placement as pins, greedy for any
    tensor the recipe doesn't name.  Explicit user pins win over the
    recipe."""
    profiles = list(profiles)
    user = dict(pins or {})
    recipe: dict[str, str] = {}
    for p in profiles:
        # a profile the user pins (by name or substring) is theirs —
        # the recipe must not shadow it with an exact-name pin
        if any(pat == p.name or pat in p.name for pat in user):
            continue
        for pat, tier in _PAPER_RECIPE_PINS:
            if pat in p.name:
                recipe[p.name] = tier
                break
    recipe.update(user)
    plan = place_greedy(profiles, topology, budgets=budgets, pins=recipe,
                        exact_threshold=0)
    return dataclasses.replace(plan, policy="paper-recipe")


def _place_everything(tier_index: int, policy: str):
    def place_all(profiles, topology, *, budgets=None, pins=None) -> Plan:
        topology = get_topology(topology)
        budgets = _budgets(topology, budgets)
        t = topology.tiers[tier_index]
        placements = {}
        used = {x.name: 0 for x in topology.tiers}
        penalty = 0.0
        for p in profiles:
            pen = topology.demotion_penalty(p, t)
            placements[p.name] = Placement(t.name, pen)
            used[t.name] += _bytes_on(p, topology, t.name)
            penalty += pen
        return Plan(placements, used, budgets, penalty, topology,
                    policy=policy)
    place_all.__doc__ = (
        f"What-if baseline: every tensor on the {'fastest' if tier_index == 0 else 'slowest'} "
        "tier (capacity reported, not enforced — Fig 10's comparison arms).")
    return place_all


# ---------------------------------------------------------------- registry
_POLICIES: dict[str, Callable] = {}


def register_policy(name: str, policy: Callable) -> None:
    _POLICIES[name] = policy


def policy_names() -> list[str]:
    return sorted(_POLICIES)


def get_policy(name: str) -> Callable:
    if name not in _POLICIES:
        raise KeyError(f"unknown placement policy {name!r}; "
                       f"known: {policy_names()}")
    return _POLICIES[name]


register_policy("greedy", place_greedy)
register_policy("exact", place_exact)
register_policy("paper-recipe", place_paper_recipe)
register_policy("all-fast", _place_everything(0, "all-fast"))
register_policy("all-slow", _place_everything(-1, "all-slow"))

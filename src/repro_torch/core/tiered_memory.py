"""DEPRECATED shim — the tiered-memory planner moved to ``repro_torch.memory``
(the port of ``repro/core/tiered_memory.py``).

The redesigned subsystem replaces this module's hardcoded two-tier
constants with a declarative, registered ``TierTopology``
(``repro_torch.memory.get_topology``), its single greedy/exact planner pair
with a named ``PlacementPolicy`` registry, and its advisory placement
with a functional ``TieredExecutor``.  Everything below delegates to
the new package on the ``tpu-hbm-host`` preset (whose tiers carry
exactly the bandwidth/capacity values these constants hardcoded), so
legacy callers keep identical numbers:

  * ``AccessProfile`` / ``gnn_recsys_profiles`` — re-exported from
    ``repro_torch.memory.profiles``;
  * ``plan_placement`` / ``plan_placement_exact`` — the ``greedy`` /
    ``exact`` policies on the default topology.  One behavioural fix
    rides the delegation: tensors pinned to the slow tier now
    contribute their *real* step penalty to ``est_step_penalty_s``
    (they used to count 0.0);
  * the ``HBM_*`` / ``HOST_*`` constants — read off the preset's tiers
    (the reference's TPU numbers, not the H100's: ``h100-hbm-host``).

New code should use ``repro_torch.memory`` directly.
"""
from __future__ import annotations

import warnings

from repro_torch.memory.policies import (Placement, Plan,  # noqa: F401
                                         place_exact, place_greedy)
from repro_torch.memory.profiles import (AccessProfile,  # noqa: F401
                                         gnn_recsys_profiles)
from repro_torch.memory.topology import get_topology

_DEFAULT = get_topology("tpu-hbm-host")

# Tier bandwidths (bytes/s), read off the tpu-hbm-host preset tiers —
# kept for legacy importers (benchmarks predating the redesign).
HBM_BW_READ = _DEFAULT.fast.read_bw
HBM_BW_WRITE = _DEFAULT.fast.write_bw
HOST_BW_READ = _DEFAULT.slow.read_bw
HOST_BW_WRITE = _DEFAULT.slow.write_bw
HBM_CAPACITY = _DEFAULT.fast.capacity
DEFAULT_HOST_CAPACITY = _DEFAULT.slow.capacity


def _warn(name: str, repl: str) -> None:
    warnings.warn(f"repro_torch.core.tiered_memory.{name} is deprecated; use "
                  f"{repl}", DeprecationWarning, stacklevel=3)


def _slow_tier_penalty(p: AccessProfile) -> float:
    """Deprecated: use ``TierTopology.demotion_penalty``."""
    return _DEFAULT.demotion_penalty(p)


def plan_placement(profiles: list[AccessProfile],
                   hbm_budget: int = HBM_CAPACITY,
                   host_budget: int = DEFAULT_HOST_CAPACITY,
                   exact_threshold: int = 16) -> Plan:
    """Deprecated: ``repro_torch.memory.get_policy('greedy')`` on a registered
    topology."""
    _warn("plan_placement", "repro_torch.memory.place_greedy / get_policy")
    return place_greedy(
        profiles, _DEFAULT,
        budgets={_DEFAULT.fast.name: int(hbm_budget),
                 _DEFAULT.slow.name: int(host_budget)},
        exact_threshold=exact_threshold)


def plan_placement_exact(profiles: list[AccessProfile],
                         hbm_budget: int = HBM_CAPACITY) -> Plan:
    """Deprecated: ``repro_torch.memory.get_policy('exact')`` on a registered
    topology."""
    _warn("plan_placement_exact", "repro_torch.memory.place_exact / get_policy")
    return place_exact(profiles, _DEFAULT,
                       budgets={_DEFAULT.fast.name: int(hbm_budget)})

"""The memory-tier subsystem (the port of ``repro/memory``).

  ``TierTopology`` / ``Tier``  — registered descriptions of the memory
      system (the reference's presets and ``h100-hbm-host``);
  ``PlacementPolicy`` registry — greedy knapsack, exact DP, the paper's
      §6 ``paper-recipe`` pins, all-fast/all-slow baselines, by name;
  ``TieredExecutor``           — makes a plan real: demoted training
      leaves live in a pinned host store, fetched to the card once per
      step and committed back after the update (int8 rows with
      ``embed_store='int8'``); demoted serving tables sit behind the
      ``HostResident`` gather facade (int8 in ``QuantizedHostResident``),
      optionally fronted by a device-resident ``HotRowCache``.

The planner entry is ``repro_torch.pipeline.plan.build_train_plan``.
"""
from repro_torch.memory.cache import CacheStats, HotRowCache
from repro_torch.memory.executor import (HostResident, QuantizedHostResident,
                                         TieredExecutor)
from repro_torch.memory.policies import (Placement, PlacementPolicy, Plan,
                                         get_policy, place_exact, place_greedy,
                                         policy_names, register_policy)
from repro_torch.memory.profiles import (AccessProfile, gnn_recsys_profiles,
                                         quantized_table_bytes)
from repro_torch.memory.topology import (Tier, TierTopology, get_topology,
                                         register_topology, resolve_tier,
                                         topology_names)

__all__ = [
    "Tier", "TierTopology", "get_topology", "register_topology",
    "topology_names", "resolve_tier",
    "AccessProfile", "gnn_recsys_profiles", "quantized_table_bytes",
    "Placement", "Plan", "PlacementPolicy", "get_policy",
    "register_policy", "policy_names", "place_greedy", "place_exact",
    "TieredExecutor", "HostResident", "QuantizedHostResident",
    "HotRowCache", "CacheStats",
]

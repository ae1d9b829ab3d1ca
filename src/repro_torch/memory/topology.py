"""TierTopology — the declarative description of a heterogeneous memory
system (the port of ``repro/memory/topology.py``).

A topology is an ordered list of named ``Tier``s, fastest first, each
carrying:

  * read/write bandwidth (bytes/s at full utilization) — the slow
    tier's write asymmetry is what makes SDDMM outputs the worst
    tensors to demote (paper Fig 8: 7.7x);
  * capacity (bytes per device) — the knapsack budget per tier;
  * access granularity — the transfer size at which the tier reaches
    peak bandwidth.  Smaller accesses get ``access/granularity``
    utilization (paper Fig 7b: Optane needs >=256 B writes; Memory
    Mode's cacheline management needs multi-KB reads);
  * ``memory_kind``, the reference's JAX memory-kind name.  It is kept
    so that one spec prices the same in both packages; the port has no
    memory kinds and always serves a demoted table from a host store
    (``memory/executor.py``).

Registered presets: the reference's four, field for field —

  ``tpu-hbm-host``           HBM (819 GB/s, 16 GiB) + host DRAM over
                             PCIe (16/8 GB/s, Optane-like asymmetry).
  ``dram-optane-appdirect``  the paper's §5 AppDirect recipe: DRAM +
                             Optane with nt-writes (read 37%, nt-write
                             18% of DRAM; 256 B saturation).
  ``dram-optane-memorymode`` the paper's Memory Mode baseline (normal
                             writes at 7%, a 4 KiB saturation point).
  ``uniform``                both tiers identical — every demotion
                             penalty is exactly 0.0.

— and the port's own:

  ``h100-hbm-host``          one H100's HBM3 (80 GB, 3.35 TB/s) + host
                             DRAM over PCIe Gen5 x16 (64 GB/s each way).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Tier:
    """One memory tier: bandwidths, capacity, and access behaviour."""
    name: str
    read_bw: float               # bytes/s at full utilization
    write_bw: float              # bytes/s at full utilization
    capacity: int                # bytes per device
    granularity: int = 1         # access size (bytes) that saturates bw
    memory_kind: str | None = None   # the reference's JAX memory kind
    #                                  ('device', 'pinned_host'); unused
    #                                  by the port

    def utilization(self, access_size: int) -> float:
        """Fraction of peak bandwidth an ``access_size``-byte touch
        achieves (paper Fig 7b's saturation curve, linear below the
        granularity point)."""
        return min(1.0, access_size / self.granularity)

    def step_time(self, read_bytes: float, write_bytes: float,
                  access_size: int) -> float:
        """Seconds/step to move this traffic through this tier."""
        util = self.utilization(access_size)
        return (read_bytes / (self.read_bw * util)
                + write_bytes / (self.write_bw * util))


@dataclasses.dataclass(frozen=True)
class TierTopology:
    """An ordered set of tiers, fastest first."""
    name: str
    tiers: tuple[Tier, ...]

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers:
            raise ValueError("a topology needs at least one tier")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in {self.name!r}: "
                             f"{names}")

    # ------------------------------------------------------------ lookup
    @property
    def fast(self) -> Tier:
        return self.tiers[0]

    @property
    def slow(self) -> Tier:
        return self.tiers[-1]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    def tier(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier {name!r} in topology {self.name!r}; "
                       f"tiers: {list(self.names)}")

    def capacities(self) -> dict[str, int]:
        return {t.name: t.capacity for t in self.tiers}

    @property
    def is_uniform(self) -> bool:
        """True when every tier moves bytes at the same speed — then no
        placement can change step time and every penalty is 0.0."""
        f = self.fast
        return all(t.read_bw == f.read_bw and t.write_bw == f.write_bw
                   and t.granularity == f.granularity for t in self.tiers)

    # ------------------------------------------------------------ cost model
    def step_time(self, profile, tier: Tier | str) -> float:
        """Seconds/step this tensor's traffic costs when resident on
        ``tier`` (profile: ``memory.profiles.AccessProfile``).

        A profile with quantized off-fast storage (``store_bytes``)
        moves proportionally fewer bytes per touch over a slow tier —
        dequant-on-gather streams the int8 rows, not the fp32 ones — so
        both the traffic and the per-touch access size scale by
        ``store_bytes/nbytes`` there."""
        t = tier if isinstance(tier, Tier) else self.tier(tier)
        rd, wr = profile.step_traffic()
        access = profile.access_size
        sb = getattr(profile, "store_bytes", None)
        if sb is not None and t.name != self.fast.name and profile.nbytes:
            f = sb / profile.nbytes
            rd, wr = rd * f, wr * f
            access = max(1, int(access * f))
        return t.step_time(rd, wr, access)

    def demotion_penalty(self, profile, tier: Tier | str | None = None
                         ) -> float:
        """Extra seconds/step if this tensor lives on ``tier`` (default:
        the slowest tier) instead of the fast tier — the quantity the
        paper's Fig 8 measures per kernel."""
        t = self.slow if tier is None else (
            tier if isinstance(tier, Tier) else self.tier(tier))
        return self.step_time(profile, t) - self.step_time(profile, self.fast)

    # ------------------------------------------------------------ derivation
    def with_capacity(self, overrides: dict[str, int]) -> "TierTopology":
        """New topology with some tiers' capacities replaced (the
        ``MemoryCfg.capacity`` override path).  Unknown tier names
        raise."""
        if not overrides:
            return self
        for k in overrides:
            self.tier(k)                      # raise on unknown names
        return TierTopology(self.name, tuple(
            dataclasses.replace(t, capacity=int(overrides[t.name]))
            if t.name in overrides else t for t in self.tiers))

    def describe(self) -> str:
        lines = [f"TierTopology[{self.name}]"]
        for t in self.tiers:
            kind = f" memory_kind={t.memory_kind}" if t.memory_kind else ""
            lines.append(
                f"  {t.name:12s} read={t.read_bw/1e9:7.1f} GB/s "
                f"write={t.write_bw/1e9:7.1f} GB/s "
                f"cap={t.capacity/2**30:8.1f} GiB "
                f"granularity={t.granularity}B{kind}")
        return "\n".join(lines)


# ---------------------------------------------------------------- registry
_TOPOLOGIES: dict[str, TierTopology] = {}


def register_topology(topo: TierTopology) -> TierTopology:
    _TOPOLOGIES[topo.name] = topo
    return topo


def topology_names() -> list[str]:
    return sorted(_TOPOLOGIES)


def get_topology(name: "str | TierTopology") -> TierTopology:
    """Resolve a topology by name (or pass one through)."""
    if isinstance(name, TierTopology):
        return name
    if name not in _TOPOLOGIES:
        raise KeyError(f"unknown memory topology {name!r}; "
                       f"known: {topology_names()}")
    return _TOPOLOGIES[name]


def resolve_tier(topology: TierTopology, label: str) -> str:
    """Tier-name aliasing for pins and legacy profiles: exact tier names
    pass through; 'fast'/'slow' (and the legacy 'hbm'/'host') map to the
    topology's first/last tier."""
    if label in topology.names:
        return label
    alias = {"fast": topology.fast.name, "hbm": topology.fast.name,
             "slow": topology.slow.name, "host": topology.slow.name}
    if label in alias:
        return alias[label]
    raise ValueError(f"unknown tier {label!r} for topology "
                     f"{topology.name!r}; tiers: {list(topology.names)} "
                     f"(aliases: fast, slow, hbm, host)")


# ---------------------------------------------------------------- presets
# The reference's TPU preset (HBM per v5e chip; a PCIe gen3 x16-ish host
# link with Optane-like R/W asymmetry), kept so one spec drives both
# packages.
register_topology(TierTopology("tpu-hbm-host", (
    Tier("hbm", read_bw=819e9, write_bw=819e9, capacity=16 * 2**30,
         granularity=1, memory_kind="device"),
    Tier("host", read_bw=16e9, write_bw=8e9, capacity=512 * 2**30,
         granularity=256, memory_kind="pinned_host"),
)))

# Paper §5, AppDirect: explicit placement, nt-writes on the slow tier
# (read 37% / nt-write 18% of DRAM; 256 B write saturation — Fig 7).
register_topology(TierTopology("dram-optane-appdirect", (
    Tier("dram", read_bw=100e9, write_bw=80e9, capacity=192 * 2**30,
         granularity=1),
    Tier("optane", read_bw=37e9, write_bw=18e9, capacity=1536 * 2**30,
         granularity=256),
)))

# Paper §5, Memory Mode: the DRAM acts as a hardware-managed cacheline
# cache in front of the same Optane pool — normal writes (7% of DRAM),
# a cache-miss read discount, and a multi-KiB saturation point because
# 64 B cacheline management wastes row-granular traffic.  Per byte this
# is strictly worse than AppDirect: the §5 qualitative ordering.
register_topology(TierTopology("dram-optane-memorymode", (
    Tier("dram-cache", read_bw=100e9, write_bw=80e9, capacity=192 * 2**30,
         granularity=1),
    Tier("optane-mm", read_bw=30e9, write_bw=7e9, capacity=1536 * 2**30,
         granularity=4096),
)))

# Two tiers, same speed: demotion penalties are exactly 0.0 and a demoted
# table round-trips its bytes, so a demoted run is bit-identical to the
# all-fast run.
register_topology(TierTopology("uniform", (
    Tier("fast", read_bw=16e9, write_bw=16e9, capacity=1 << 62,
         granularity=1),
    Tier("slow", read_bw=16e9, write_bw=16e9, capacity=1 << 62,
         granularity=1),
)))

# One NVIDIA H100 SXM behind PCIe Gen5 x16.  NVIDIA datasheet values, not
# measurements: HBM3 80 GB at 3.35 TB/s; the host link 64 GB/s each way.
# The host tier's capacity and access granularity are the reference's
# ``tpu-hbm-host`` host-tier values.
register_topology(TierTopology("h100-hbm-host", (
    Tier("hbm", read_bw=3.35e12, write_bw=3.35e12, capacity=80 * 10**9,
         granularity=1),
    Tier("host", read_bw=64e9, write_bw=64e9, capacity=512 * 2**30,
         granularity=256),
)))

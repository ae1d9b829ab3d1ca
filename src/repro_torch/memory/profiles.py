"""AccessProfile — the per-tensor traffic descriptor every placement
policy consumes (paper §2.1's memory model, per tensor; the port of
``repro/memory/profiles.py``).

The profile is topology-independent — bytes, reads and writes per step,
and the access granularity of one touch — and the topology's cost model
turns it into a per-tier step time.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AccessProfile:
    """Static per-step traffic descriptor for one tensor."""
    name: str
    nbytes: int
    reads_per_step: float = 1.0     # full-tensor read equivalents
    writes_per_step: float = 0.0    # full-tensor write equivalents
    access_size: int = 512          # bytes per touch (embedding row, tile, ...)
    pinned: str | None = None       # force a tier by name, or the
    #                                 'fast'/'slow' ('hbm'/'host') aliases
    store_bytes: int | None = None  # bytes this tensor occupies when it
    #                                 lives OFF the fast tier (quantized
    #                                 capacity-tier storage, e.g. int8
    #                                 embedding tables at ~1/4 bytes);
    #                                 None -> stored dense (nbytes)

    def step_traffic(self) -> tuple[float, float]:
        return (self.nbytes * self.reads_per_step,
                self.nbytes * self.writes_per_step)

    def bytes_on(self, fast: bool) -> int:
        """Resident bytes on a tier: the dense ``nbytes`` on the fast
        tier (tensors are always computed on in fp32 there), the
        quantized ``store_bytes`` on any slower tier when set."""
        return self.nbytes if fast or self.store_bytes is None \
            else self.store_bytes


# ---------------------------------------------------------------------------
# Workload profile builders (used by configs and benchmarks)

def quantized_table_bytes(n_rows: int, row_bytes: int,
                          dtype_bytes: int = 4) -> int:
    """Capacity-tier footprint of an int8-stored embedding table: one
    byte per element plus a per-row fp32 scale — the ~4x capacity
    multiplier the planner prices (``AccessProfile.store_bytes``)."""
    return n_rows * (row_bytes // dtype_bytes) + n_rows * 4


def gnn_recsys_profiles(n_users: int, n_items: int, n_edges: int,
                        embed_dim: int, n_layers: int,
                        dtype_bytes: int = 4,
                        embed_store: str = "fp32",
                        fused_messages: bool = False) -> list[AccessProfile]:
    """Paper §2.1 memory model: len(m)*|E| per layer for messages,
    len(x)*|V| for embeddings, doubled for training (grads).  With
    ``embed_store='int8'`` the embedding table carries a quantized
    capacity-tier footprint (``store_bytes`` at ~1/4 bytes).  ``fused_messages``
    models the fused Hadamard-SpMM route: the per-layer [E, D] message
    stream never exists, so its profiles are dropped entirely."""
    v = n_users + n_items
    row = embed_dim * dtype_bytes
    embed_sb = quantized_table_bytes(v, row, dtype_bytes) \
        if embed_store == "int8" else None
    out = [
        AccessProfile("embeddings", v * row, reads_per_step=2 * n_layers,
                      writes_per_step=2.0, access_size=row,
                      store_bytes=embed_sb),
        AccessProfile("embed_grads", v * row, reads_per_step=1.0,
                      writes_per_step=2 * n_layers, access_size=row),
        AccessProfile("opt_state", 2 * v * row, reads_per_step=1.0,
                      writes_per_step=1.0, access_size=row),
        AccessProfile("graph_coo", 2 * n_edges * 8, reads_per_step=2 * n_layers,
                      writes_per_step=0.0, access_size=8),
    ]
    for l in range(n_layers):
        # SDDMM output: written once (streaming), read once by SpMM; and
        # re-read/re-written in backward.  The fused Hadamard-SpMM
        # route forms the product in VMEM only — no stream to profile.
        if not fused_messages:
            out.append(AccessProfile(f"messages_l{l}", n_edges * row,
                                     reads_per_step=2.0,
                                     writes_per_step=2.0,
                                     access_size=row))
        out.append(AccessProfile(f"activations_l{l}", v * row,
                                 reads_per_step=2.0, writes_per_step=2.0,
                                 access_size=row))
    return out

"""The batching half of ``repro/pipeline/plan.py``: how a target batch
splits into accumulated microbatches.  Placement over memory tiers
(``Plan``, the policies, ``TieredExecutor``) is ROADMAP A5; until it
lands the port takes the microbatch from its caller."""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.large_batch import LargeBatchSchedule


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


@dataclasses.dataclass
class TrainPlan:
    """The batching of one training configuration: ``microbatch`` samples
    per accumulation chunk.  The port runs one shard, so the reference's
    per-shard and global microbatch are the same number."""
    sched: LargeBatchSchedule
    microbatch: int

    def microbatches_for_epoch(self, epoch: int) -> int:
        return max(1, math.ceil(self.sched.batch_for_epoch(epoch)
                                / self.microbatch))

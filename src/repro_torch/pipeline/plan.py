"""The batching and serving halves of ``repro/pipeline/plan.py``: how a
target batch splits into accumulated microbatches, and the access
profiles the serving snapshot is placed by.  Training placement
(``profiles_from_state``, ``build_train_plan``) is ROADMAP A5; until it
lands the port takes the microbatch from its caller."""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.large_batch import LargeBatchSchedule
from repro_torch.memory import AccessProfile


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
    """The batching of one training configuration: ``microbatch`` samples
    per accumulation chunk.  The port runs one shard, so the reference's
    per-shard and global microbatch are the same number."""
    sched: LargeBatchSchedule
    microbatch: int

    def microbatches_for_epoch(self, epoch: int) -> int:
        return max(1, math.ceil(self.sched.batch_for_epoch(epoch)
                                / self.microbatch))

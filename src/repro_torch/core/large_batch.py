"""Large-batch training schedule (paper §7.1; the port of
``repro/core/large_batch.py``):
  1. linear learning-rate scaling (Goyal et al.): lr = base_lr · B/B_base
     (square-root scaling is kept for the paper's ablation);
  2. a warm-up *batch-size* schedule: the first ``warmup_epochs`` epochs
     run batch = target/10, then the target batch.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LargeBatchSchedule:
    base_lr: float
    base_batch: int
    target_batch: int
    warmup_epochs: int = 2
    warmup_divisor: int = 10      # paper: warm-up batch = target/10
    scaling: str = "linear"       # 'linear' (paper) | 'sqrt' (ablation)

    def batch_for_epoch(self, epoch: int) -> int:
        if epoch < self.warmup_epochs:
            return max(self.base_batch, self.target_batch // self.warmup_divisor)
        return self.target_batch

    def lr_for_epoch(self, epoch: int) -> float:
        return self.scaled_lr(self.batch_for_epoch(epoch))

    def scaled_lr(self, batch: int) -> float:
        """LR for the batch actually run, under the configured rule."""
        if self.scaling == "sqrt":
            return self.sqrt_scaled_lr(batch)
        return self.linear_scaled_lr(batch)

    def linear_scaled_lr(self, batch: int) -> float:
        return self.base_lr * (batch / self.base_batch)

    def sqrt_scaled_lr(self, batch: int) -> float:
        return self.base_lr * (batch / self.base_batch) ** 0.5

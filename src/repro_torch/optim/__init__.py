"""Functional optimizers over nested dicts and lists of tensors."""
from repro_torch.optim.optimizers import (Optimizer, WarmupLinearLR, adafactor,
                                          adam, global_norm_clip, sgd)

__all__ = ["Optimizer", "WarmupLinearLR", "adafactor", "adam",
           "global_norm_clip", "sgd"]

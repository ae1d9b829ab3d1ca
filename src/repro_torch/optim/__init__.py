"""Functional optimizers over nested dicts and lists of tensors."""
from repro_torch.optim.optimizers import (Optimizer, WarmupLinearLR, adam,
                                          global_norm_clip, sgd)

__all__ = ["Optimizer", "WarmupLinearLR", "adam", "global_norm_clip", "sgd"]

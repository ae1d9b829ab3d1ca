"""Functional optimizers over nested dicts and lists of tensors."""
from repro_torch.optim.optimizers import Optimizer, adam, sgd

__all__ = ["Optimizer", "adam", "sgd"]

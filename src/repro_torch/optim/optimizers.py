"""Functional optimizers (init/update pairs): the port of
``repro/optim/optimizers.py::sgd`` and ``adam``.

Parameters are nested dicts and lists of tensors (NGCF's ``w1``/``w2``
lists, GCN's ``layers`` list of dicts).  The updates follow the
reference's formulas exactly rather than ``torch.optim``: Adam's bias
corrections ``1 - b ** t`` are float32 computations on a float32 ``t``,
as in JAX, and the learning rate may come as a float32 scalar tensor
(the engine passes the epoch's LR so).  Updates return new tensors and
leave their inputs as they were, as the reference's pure functions do.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts/lists/tuples that
    share ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params[, lr=...]) -> (new_params, new_state)
    update: Callable[..., tuple[Any, Any]]


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, lr=lr):
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        new_p = tree_map(lambda p, m: p - lr * m, params, new_m)
        return new_p, new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr=None):
        t = state["t"] + 1
        step_lr = lr if lr is not None else base_lr
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)
        tf = t.to(torch.float32)
        # float32 bias corrections, as jnp computes them
        bc1 = 1 - torch.full_like(tf, b1) ** tf
        bc2 = 1 - torch.full_like(tf, b2) ** tf
        new_p = tree_map(
            lambda p, m_, v_: p - step_lr * (m_ / bc1)
            / (torch.sqrt(v_ / bc2) + eps), params, m, v)
        return new_p, {"m": m, "v": v, "t": t}

    base_lr = lr
    return Optimizer(init, update)

"""The full-graph training step on the seed COO path: forward over the
whole graph, BPR loss, one optimizer update — the step of the reference's
NGCF/LightGCN FULL cells (``repro/launch/cells.py:739-776``), whose
forward is ``ngcf.forward(p, g, opt_level=3)`` or
``lightgcn.forward(p, g, n_layers)``.

``bpr_value_and_grad`` is the step's loss and gradients alone (the
paper's Fig 5 training arm, and the full-graph arm of the subgraph
comparison); ``value_and_grad`` is the same for any loss of a param tree
(the legacy trainers' and the model pool's)."""
from __future__ import annotations

import torch

from repro_torch.core import bpr
from repro_torch.optim.optimizers import Optimizer, tree_leaves, tree_map


def value_and_grad(loss_of, params):
    """(loss, grads) of ``loss_of(params)``; ``grads`` has ``params``'
    structure and ``params`` are not modified."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_of(live)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def bpr_value_and_grad(forward, params, users, pos, neg):
    """(loss, grads) of the BPR loss of ``forward(params) -> (user_emb,
    item_emb)``; ``grads`` has ``params``' structure and ``params`` are
    not modified."""
    return value_and_grad(
        lambda p: bpr.bpr_loss(*forward(p), users, pos, neg), params)


def full_graph_step(forward, opt: Optimizer):
    """``step(params, opt_state, users, pos, neg) -> (params, opt_state,
    loss)``: value and grad of the BPR loss of ``forward``, then
    ``opt.update``."""
    def step(params, opt_state, users, pos, neg):
        loss, grads = bpr_value_and_grad(forward, params, users, pos, neg)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step

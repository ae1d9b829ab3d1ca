"""BPR training steps of the reference: the batches, the loss, Adam.

The batches follow the configuration's schedule from ``--seed`` alone:
epoch e visits the train edges in the order of a permutation drawn by
``numpy.random.default_rng((seed, e))``, ``batch`` edges a step (a
partial last batch dropped); step s's negatives are ``batch`` item ids
drawn uniformly by ``default_rng((seed, s))``.  The loss is BPR on the
final embeddings, -mean log sigmoid(s(u, i+) - s(u, i-)), plus l2 times
the mean squared norm of each of the three gathered rows.  Adam is the
textbook update with bias corrections (b1 0.9, b2 0.999, eps 1e-8).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import dtype_of, precision

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(params: dict) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every parameter, tables first, then per layer."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, (list, tuple)):
            out.extend((f"{k}[{i}]", t) for i, t in enumerate(v))
        else:
            out.append((k, v))
    return out


def batch(user: np.ndarray, item: np.ndarray, n_items: int, seed: int,
          size: int, step: int):
    """(users, pos, neg) int64 arrays of one step."""
    per_epoch = len(user) // size
    epoch, pos_in = divmod(step, per_epoch)
    perm = np.random.default_rng((seed, epoch)).permutation(len(user))
    idx = perm[pos_in * size:(pos_in + 1) * size]
    neg = np.random.default_rng((seed, step)).integers(0, n_items, size)
    return (user[idx].astype(np.int64), item[idx].astype(np.int64),
            neg.astype(np.int64))


def bpr_loss(ue, ie, users, pos, neg, l2: float) -> torch.Tensor:
    eu, ep, en = ue[users], ie[pos], ie[neg]
    diff = (eu * ep).sum(-1) - (eu * en).sum(-1)
    loss = -F.logsigmoid(diff).mean()
    reg = (eu * eu).sum(-1).mean() + (ep * ep).sum(-1).mean() \
        + (en * en).sum(-1).mean()
    return loss + l2 * reg


@dataclasses.dataclass
class Follow:
    """What the reference reads from the steps it follows."""
    losses: list[float]
    grad_norms: dict[str, float]      # first step's gradient, per leaf
    change_norms: dict[str, float]    # params after the steps - before


def unflatten(params: dict, arrays: list) -> dict:
    """``arrays`` (in ``leaves`` order) in the tree structure of
    ``params``."""
    it = iter(arrays)
    return {k: ([next(it) for _ in v] if isinstance(v, (list, tuple))
                else next(it)) for k, v in sorted(params.items())}


def follow(arch, params: dict, graph, user: np.ndarray, item: np.ndarray,
           *, n_layers: int, batch_size: int, lr: float, l2: float,
           seed: int, steps: int = 3, precision_name: str = "float32",
           moments: tuple[list, list] | None = None, t0: int = 0,
           step0: int = 0) -> Follow:
    """``steps`` Adam steps from ``params`` (float32 masters, updated
    in float32); the forward, the loss and the backward run in
    ``precision_name``.  From the seed's start by default; otherwise
    from Adam's ``moments`` (m, v in ``leaves`` order) after ``t0`` of
    its steps, taking the batches of steps ``step0``, ``step0 + 1``, ...
    (``params`` may then live on the host: they move to the graph's
    device)."""
    dt = dtype_of(precision_name)
    dev = graph.user.device
    names = [n for n, _ in leaves(params)]
    p = [t.detach().to(dev, copy=True) for _, t in leaves(params)]
    p0 = [t.clone() for t in p]
    if moments is None:
        m = [torch.zeros_like(t) for t in p]
        v = [torch.zeros_like(t) for t in p]
    else:
        m = [t.to(dev, copy=True) for t in moments[0]]
        v = [t.to(dev, copy=True) for t in moments[1]]
    losses, grad_norms = [], {}
    with precision(precision_name):
        for s in range(steps):
            u, ip, ineg = (torch.from_numpy(a).to(dev) for a in
                           batch(user, item, graph.n_items, seed,
                                 batch_size, step0 + s))
            live = [t.detach().to(dt).requires_grad_(True) for t in p]
            ue, ie = arch.forward(unflatten(params, live), graph, n_layers)
            loss = bpr_loss(ue, ie, u, ip, ineg, l2)
            grads = torch.autograd.grad(loss, live)
            del ue, ie
            losses.append(float(loss.detach().float()))
            grads = [g.float() for g in grads]
            if s == 0:
                grad_norms = {n: float(g.double().norm())
                              for n, g in zip(names, grads)}
            del live
            t = t0 + s + 1
            bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
            with torch.no_grad():
                for j, g in enumerate(grads):
                    m[j] = B1 * m[j] + (1 - B1) * g
                    v[j] = B2 * v[j] + (1 - B2) * g * g
                    p[j] = p[j] - lr * (m[j] / bc1) \
                        / ((v[j] / bc2).sqrt() + EPS)
            del grads
    change = {n: float((a - b).double().norm())
              for n, a, b in zip(names, p, p0)}
    return Follow(losses, grad_norms, change)

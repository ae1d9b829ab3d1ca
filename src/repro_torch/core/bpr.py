"""Bayesian Personalized Ranking (the port of ``repro/core/bpr.py``):
the BPR loss, uniform negative sampling and the user-CSR helper."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def bpr_loss(user_e: torch.Tensor, item_e: torch.Tensor, users, pos_items,
             neg_items, l2: float = 1e-4) -> torch.Tensor:
    """-log sigma(s(u,i+) - s(u,i-)) + L2 on the touched embeddings."""
    eu = user_e[users]
    ep = item_e[pos_items]
    en = item_e[neg_items]
    pos = torch.sum(eu * ep, -1)
    neg = torch.sum(eu * en, -1)
    loss = -torch.mean(F.logsigmoid(pos - neg))
    reg = l2 * (torch.mean(torch.sum(eu ** 2, -1))
                + torch.mean(torch.sum(ep ** 2, -1))
                + torch.mean(torch.sum(en ** 2, -1)))
    return loss + reg


def sample_bpr_batch(rng: np.random.Generator, train_user: np.ndarray,
                     train_item: np.ndarray, n_items: int, batch: int):
    """Uniform (u, i+, i-) tuples from observed interactions; i- is uniform
    over the catalogue.  The same generator state gives the reference's
    bytes."""
    idx = rng.integers(0, len(train_user), batch)
    users = train_user[idx]
    pos = train_item[idx]
    neg = rng.integers(0, n_items, batch)
    return users.astype(np.int32), pos.astype(np.int32), neg.astype(np.int32)


def build_user_csr(user: np.ndarray, item: np.ndarray,
                   n_users: int) -> tuple[np.ndarray, np.ndarray]:
    """(indptr i64, items i64) user-CSR over interaction edges:
    items[indptr[u]:indptr[u+1]] are user u's item ids, in edge order.
    O(E) — the seen-item structure of evaluation and serving."""
    user = np.asarray(user)
    item = np.asarray(item)
    order = np.argsort(user, kind="stable")
    indptr = np.zeros(n_users + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(user, minlength=n_users))
    return indptr, item[order].astype(np.int64)

"""Bayesian Personalized Ranking (the port of ``repro/core/bpr.py``):
the BPR loss, uniform negative sampling, the user-CSR helper and the
dense recall@K oracle."""
from __future__ import annotations

import warnings

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


def recall_at_k(user_e, item_e, train, test_pos: list[np.ndarray],
                k: int = 20) -> float:
    """Dense-score recall@k — the small-graph reference oracle (it still
    materializes the U×I score matrix; production eval is the streaming
    path in ``repro_torch.eval``).

    ``user_e``/``item_e`` are tensors or numpy arrays; the scores
    ``user_e @ item_e.T`` come to the host, where the rest runs in numpy
    as the reference's does, so the same scores give the same recall bit
    for bit.  ``train`` masks already-seen items, either as the (indptr,
    items) user-CSR from ``build_user_csr`` (canonical — O(E)), or as the
    legacy dense boolean mask [U, I] (deprecated; itself O(U×I)).
    test_pos[u] = array of held-out item ids."""
    scores = (torch.as_tensor(user_e) @ torch.as_tensor(item_e).T
              ).detach().cpu().numpy()
    if isinstance(train, np.ndarray):
        if train.ndim != 2 or train.dtype != bool:
            raise TypeError("dense train mask must be a 2-D boolean array; "
                            "pass build_user_csr(...) otherwise")
        warnings.warn(
            "passing a dense [U, I] boolean train mask to recall_at_k is "
            "deprecated (it materializes the U×I matrix twice); pass the "
            "(indptr, items) user-CSR from build_user_csr, or use the "
            "streaming evaluation in repro_torch.eval (evaluate_embeddings)",
            DeprecationWarning, stacklevel=2)
        scores[train] = -np.inf            # legacy dense-mask shim
    else:
        indptr, items = train
        indptr = np.asarray(indptr)
        items = np.asarray(items)
        rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        scores[rows, items] = -np.inf
    topk = np.argpartition(-scores, min(k, scores.shape[1] - 1), axis=1)[:, :k]
    recalls = []
    for u, pos in enumerate(test_pos):
        if len(pos) == 0:
            continue
        hits = np.intersect1d(topk[u], pos).size
        recalls.append(hits / len(pos))
    return float(np.mean(recalls)) if recalls else 0.0

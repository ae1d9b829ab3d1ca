"""Seen-masked top-K of the reference, by (score desc, item id asc).

Scores are ``u · i`` over every item.  The order is a total order on the
float32 bits: -0.0 counts as +0.0, and the int32 key ``b ^ ((b >> 31) &
0x7fffffff)`` of the bits ranks +NaN above +inf and -NaN below -inf, as
IEEE total order does.  Seen items take no slot; a user with fewer than K
unseen items gets (-1, -inf) in the slots left over.
"""
from __future__ import annotations

import torch


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys whose integer order is the scores' total order."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    b = s.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def seen_mask(users: torch.Tensor, indptr: torch.Tensor,
              items: torch.Tensor, n_items: int) -> torch.Tensor:
    """bool [len(users), n_items]: True where the user has seen the item."""
    start, end = indptr[users], indptr[users + 1]
    deg = end - start
    rows = torch.repeat_interleave(torch.arange(users.numel(),
                                                device=users.device), deg)
    offs = torch.arange(int(deg.sum()), device=users.device) \
        - torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
    cols = items[torch.repeat_interleave(start, deg) + offs]
    mask = torch.zeros((users.numel(), n_items), dtype=torch.bool,
                       device=users.device)
    mask[rows, cols] = True
    return mask


def user_csr(user: torch.Tensor, item: torch.Tensor, n_users: int):
    """(indptr, items) int64: each user's seen items, from the edge arrays."""
    order = torch.argsort(user.to(torch.int64), stable=True)
    indptr = torch.zeros(n_users + 1, dtype=torch.int64, device=user.device)
    indptr[1:] = torch.cumsum(torch.bincount(user.to(torch.int64),
                                             minlength=n_users), 0)
    return indptr, item.to(torch.int64)[order]


def topk(scores: torch.Tensor, seen: torch.Tensor, k: int):
    """(ids int64 [n, k], scores [n, k]) of the best unseen items."""
    key = order_key(scores.float()).to(torch.int64)
    # below every real key: seen items sort last
    key = torch.where(seen, torch.full_like(key, -(1 << 40)), key)
    _, order = torch.sort(key, dim=1, descending=True, stable=True)
    ids = order[:, :k]
    valid = ~torch.gather(seen, 1, ids)
    top = torch.gather(scores, 1, ids)
    ids = torch.where(valid, ids, torch.full_like(ids, -1))
    top = torch.where(valid, top, torch.full_like(top, float("-inf")))
    return ids, top

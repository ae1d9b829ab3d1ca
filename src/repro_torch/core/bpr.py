"""User-CSR of interactions (the port's copy of ``repro/core/bpr.py``'s
``build_user_csr``; the BPR loss comes with the training slice)."""
from __future__ import annotations

import numpy as np


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

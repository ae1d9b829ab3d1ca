"""Kronecker expansion of interaction graphs (Belletti et al. 2019,
arXiv:1901.08910) — the paper's method for growing movielens/gowalla/
amazon-book into the 250M-1.2B edge benchmark graphs (m-x25, g-x256, ...).

A' = K (x) A for a small binary expander K [ku, ki]:
  edge (u, i) of A and edge (a, b) of K produce
  (a * n_users + u, b * n_items + i).
Edge count multiplies by nnz(K); the per-block degree distribution (and
hence the power law, community structure, item popularity) is preserved.

The port's copy of ``repro/data/kronecker.py`` (numpy only): the same
seed gives the same arrays, byte for byte.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synth import InteractionData


def expander_matrix(ku: int, ki: int, nnz: int, seed: int = 0) -> np.ndarray:
    """Random binary expander with exactly nnz ones, diagonal-ish bias so
    the expansion keeps community structure (blocks mostly map to
    themselves)."""
    rng = np.random.default_rng(seed)
    k = np.zeros((ku, ki), dtype=bool)
    d = min(ku, ki)
    k[np.arange(d) % ku, np.arange(d) % ki] = True  # diagonal backbone
    need = nnz - k.sum()
    if need < 0:
        raise ValueError("nnz smaller than diagonal backbone")
    flat = np.flatnonzero(~k.reshape(-1))
    extra = rng.choice(flat, int(need), replace=False)
    k.reshape(-1)[extra] = True
    return k


def kronecker_expand(data: InteractionData, k: np.ndarray) -> InteractionData:
    """A' = K (x) A on edge lists."""
    ka, kb = np.nonzero(k)
    nu, ni = data.n_users, data.n_items
    # broadcast: every K-edge replicates every A-edge into a shifted block
    user = (ka[:, None].astype(np.int64) * nu + data.user[None, :]).reshape(-1)
    item = (kb[:, None].astype(np.int64) * ni + data.item[None, :]).reshape(-1)
    return InteractionData(user.astype(np.int64), item.astype(np.int64),
                           k.shape[0] * nu, k.shape[1] * ni)


def expand_by_factor(data: InteractionData, factor: int,
                     seed: int = 0) -> InteractionData:
    """Expand edge count by ~``factor`` (paper: m-x25 = movielens x25).
    Uses a ceil(sqrt(factor))-square expander with ``factor`` nonzeros."""
    side = int(np.ceil(np.sqrt(factor)))
    k = expander_matrix(side, side, factor, seed=seed)
    return kronecker_expand(data, k)

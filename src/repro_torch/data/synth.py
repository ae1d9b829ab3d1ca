"""Synthetic user-item bipartite graphs with power-law degree structure.

The paper's real datasets (movielens-10m / gowalla / amazon-book) are
external downloads; we reproduce their published shape statistics
(Table 2: #users, #items, density) with a Zipf-popularity generator so
accuracy/perf experiments run hermetically.  ``DATASET_STATS`` carries
the paper's exact numbers; ``scaled(name, factor)`` gives the same
density at reduced size for CPU-runnable accuracy tests.

The port's own copy of ``repro/data/synth.py`` (numpy only): the same
seed gives the same arrays, byte for byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bpr import build_user_csr

# Paper Table 2 (users, items, interactions).
DATASET_STATS = {
    "movielens-10m": (70_000, 11_000, 10_000_000),
    "gowalla": (30_000, 41_000, 1_000_000),
    "amazon-book": (53_000, 92_000, 3_000_000),
    "m-x25": (349_000, 53_000, 250_000_000),
    "g-x256": (478_000, 656_000, 263_000_000),
    "a-x100": (526_000, 916_000, 298_000_000),
    "m-x100": (699_000, 107_000, 1_000_000_000),
    "g-x1024": (955_000, 1_311_000, 1_052_000_000),
    "a-x400": (1_053_000, 1_832_000, 1_194_000_000),
}


@dataclasses.dataclass
class InteractionData:
    user: np.ndarray   # int32[E]
    item: np.ndarray   # int32[E]
    n_users: int
    n_items: int

    @property
    def n_edges(self) -> int:
        return len(self.user)

    @property
    def density(self) -> float:
        return self.n_edges / (self.n_users * self.n_items)


def zipf_probs(n: int, alpha: float = 1.05) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** alpha
    return p / p.sum()


def generate_bipartite(n_users: int, n_items: int, n_edges: int,
                       seed: int = 0, alpha: float = 1.05) -> InteractionData:
    """Power-law bipartite generator: user activity and item popularity
    both Zipf-distributed (matches the paper's Fig 13 degree shape).
    Deduplicates; may return slightly fewer than n_edges."""
    rng = np.random.default_rng(seed)
    pu = zipf_probs(n_users, alpha)
    pi = zipf_probs(n_items, alpha)
    # sample-dedup-resample until filled (Zipf heads collide heavily)
    keys: np.ndarray = np.zeros(0, np.int64)
    for _ in range(12):
        need = n_edges - len(keys)
        if need <= 0:
            break
        m = int(need * 1.5) + 16
        u = rng.choice(n_users, m, p=pu)
        i = rng.choice(n_items, m, p=pi)
        keys = np.unique(np.concatenate([keys, u.astype(np.int64) * n_items + i]))
    if len(keys) > n_edges:
        keys = rng.choice(keys, n_edges, replace=False)
    u = (keys // n_items).astype(np.int32)
    i = (keys % n_items).astype(np.int32)
    # shuffle user/item id space so ids are not popularity-ordered
    uperm = rng.permutation(n_users).astype(np.int32)
    iperm = rng.permutation(n_items).astype(np.int32)
    return InteractionData(uperm[u], iperm[i], n_users, n_items)


def scaled(name: str, target_edges: int, seed: int = 0) -> InteractionData:
    """Same density/aspect as the named paper dataset, shrunk so that it
    has ~target_edges interactions."""
    nu, ni, ne = DATASET_STATS[name]
    f = (target_edges / ne) ** 0.5
    return generate_bipartite(max(int(nu * f), 16), max(int(ni * f), 16),
                              target_edges, seed=seed)


def group_by_user(user: np.ndarray, item: np.ndarray,
                  n_users: int) -> list[np.ndarray]:
    """Per-user item lists: out[u] = item ids of user u's interactions
    (empty array when none).  The held-out ``test_pos`` structure the
    eval metrics consume — the user-CSR sliced into views, no U×I
    anything."""
    indptr, items = build_user_csr(user, item, n_users)
    return [items[indptr[u]:indptr[u + 1]] for u in range(n_users)]


def train_test_split(data: InteractionData, test_frac: float = 0.1,
                     seed: int = 0):
    """Paper protocol: 90/10 edge split."""
    rng = np.random.default_rng(seed)
    e = data.n_edges
    perm = rng.permutation(e)
    cut = int(e * (1 - test_frac))
    tr, te = perm[:cut], perm[cut:]
    train = InteractionData(data.user[tr], data.item[tr], data.n_users, data.n_items)
    test = InteractionData(data.user[te], data.item[te], data.n_users, data.n_items)
    return train, test

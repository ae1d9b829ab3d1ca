"""The seeded user-item graph of every cell, generated on the device.

A torch rewrite of the algorithm of the port's numpy generator
(``generate_bipartite`` and ``train_test_split``): user activity and item
popularity both Zipf(alpha) over their id ranks, edges sampled from the
two marginals, deduplicated and resampled until the requested count is
reached (Zipf heads collide heavily), a random subset kept where there
are too many, both id spaces shuffled so ids are not popularity-ordered,
then the 90/10 edge split.  Every draw comes from one ``torch.Generator``
seeded with ``--seed`` on the graph's device, in a few large calls, so the
same seed on the same kind of device gives the same arrays, and no graph
is generated on the host.  The numbers differ from the numpy generator's
(another random stream); the degree statistics agree.
"""
from __future__ import annotations

import dataclasses

import torch

RESAMPLE_ROUNDS = 12


@dataclasses.dataclass
class Graph:
    """Train and held-out edges (int32 tensors on one device)."""
    train_user: torch.Tensor
    train_item: torch.Tensor
    test_user: torch.Tensor
    test_item: torch.Tensor
    n_users: int
    n_items: int

    @property
    def n_train(self) -> int:
        return int(self.train_user.numel())


def _zipf_cdf(n: int, alpha: float, device) -> torch.Tensor:
    """Cumulative Zipf(alpha) probabilities over ranks 1..n, float64."""
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-alpha)
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def _draw(cdf: torch.Tensor, m: int, gen: torch.Generator) -> torch.Tensor:
    """m ranks (0-based, int64) drawn by inverse CDF."""
    r = torch.rand(m, generator=gen, dtype=torch.float64, device=cdf.device)
    idx = torch.searchsorted(cdf, r, right=True)
    return idx.clamp_(max=cdf.numel() - 1)


def generate(n_users: int, n_items: int, n_edges: int, seed: int,
             alpha: float = 1.05, test_frac: float = 0.1,
             device="cuda") -> Graph:
    """The cell's graph from ``seed``: about ``n_edges`` distinct (user,
    item) pairs (fewer where twelve rounds of resampling cannot fill the
    count), split ``1 - test_frac`` / ``test_frac`` into train and
    held-out edges."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    cu = _zipf_cdf(n_users, alpha, dev)
    ci = _zipf_cdf(n_items, alpha, dev)
    keys = torch.zeros(0, dtype=torch.int64, device=dev)
    for _ in range(RESAMPLE_ROUNDS):
        need = n_edges - keys.numel()
        if need <= 0:
            break
        m = int(need * 1.5) + 16
        u = _draw(cu, m, gen)
        i = _draw(ci, m, gen)
        keys = torch.unique(torch.cat([keys, u * n_items + i]))
    if keys.numel() > n_edges:
        keep = torch.randperm(keys.numel(), generator=gen, device=dev)
        keys = keys[keep[:n_edges]]
    uperm = torch.randperm(n_users, generator=gen, device=dev)
    iperm = torch.randperm(n_items, generator=gen, device=dev)
    user = uperm[keys // n_items].to(torch.int32)
    item = iperm[keys % n_items].to(torch.int32)
    del keys
    e = user.numel()
    perm = torch.randperm(e, generator=gen, device=dev)
    cut = int(e * (1 - test_frac))
    tr, te = perm[:cut], perm[cut:]
    return Graph(user[tr].contiguous(), item[tr].contiguous(),
                 user[te].contiguous(), item[te].contiguous(),
                 int(n_users), int(n_items))

"""The device generator: determinism by seed, distinct edges, the edge
count and the split, and Zipf degree statistics close to the program's
numpy generator at a small size."""
import numpy as np
import torch

from perfbench.data import graph

N_U, N_I, N_E = 3000, 2000, 60_000


def _edges(g):
    u = torch.cat([g.train_user, g.test_user]).long()
    i = torch.cat([g.train_item, g.test_item]).long()
    return u, i


def test_same_seed_same_arrays_other_seed_other():
    a = graph.generate(N_U, N_I, N_E, seed=2**31 + 7, device="cpu")
    b = graph.generate(N_U, N_I, N_E, seed=2**31 + 7, device="cpu")
    c = graph.generate(N_U, N_I, N_E, seed=5, device="cpu")
    for x, y in ((a.train_user, b.train_user), (a.train_item, b.train_item),
                 (a.test_user, b.test_user), (a.test_item, b.test_item)):
        assert torch.equal(x, y)
    assert not torch.equal(a.train_user, c.train_user)


def test_distinct_edges_count_and_split():
    g = graph.generate(N_U, N_I, N_E, seed=11, device="cpu")
    u, i = _edges(g)
    keys = u * N_I + i
    assert keys.unique().numel() == keys.numel()
    assert keys.numel() == N_E
    assert g.n_train == int(N_E * 0.9)
    assert int(u.min()) >= 0 and int(u.max()) < N_U
    assert int(i.min()) >= 0 and int(i.max()) < N_I
    assert g.train_user.dtype == torch.int32


def _degree_stats(deg):
    d = np.sort(deg)[::-1].astype(np.float64)
    tot = d.sum()
    return {"top1pct_share": d[:max(1, len(d) // 100)].sum() / tot,
            "top10pct_share": d[:len(d) // 10].sum() / tot,
            "zero_share": float(np.mean(d == 0)),
            "max_share": d[0] / tot}


def test_degree_statistics_match_the_programs_generator():
    from repro_torch.data import synth
    ref = synth.generate_bipartite(N_U, N_I, N_E, seed=3)
    g = graph.generate(N_U, N_I, N_E, seed=3, device="cpu")
    u, i = _edges(g)
    assert abs(len(u) - ref.n_edges) <= N_E // 100
    for ours, theirs in ((np.bincount(u.numpy(), minlength=N_U),
                          np.bincount(ref.user, minlength=N_U)),
                         (np.bincount(i.numpy(), minlength=N_I),
                          np.bincount(ref.item, minlength=N_I))):
        a, b = _degree_stats(ours), _degree_stats(theirs)
        for k in a:
            assert abs(a[k] - b[k]) <= 0.1 * b[k] + 0.005, (k, a, b)

"""The frozen reference held to the program on a small graph (CPU).

A test may import both; the reference imports nothing of the program
(``test_perfbench_isolation.py``)."""
import numpy as np
import pytest
import torch

from perfbench import reference
from perfbench.data import graph as gen
from perfbench.reference import graph as ref_graph
from perfbench.reference import topk as ref_topk
from perfbench.reference import train as ref_train

N_U, N_I, N_E, D = 400, 300, 8000, 16


@pytest.fixture(scope="module")
def edges():
    g = gen.generate(N_U, N_I, N_E, seed=99, device="cpu")
    return g.train_user.numpy(), g.train_item.numpy()


def _port(arch, edges, layers):
    from repro_torch.pipeline.registry import get_model
    from repro_torch.pipeline.sparse import BipartiteCSR
    u, i = edges
    g = BipartiteCSR(u, i, N_U, N_I, device="cpu")
    spec = get_model(arch)
    return spec, g, spec.init(7, N_U, N_I, D, layers, device="cpu")


@pytest.mark.parametrize("arch,layers", [("lightgcn", 3), ("ngcf", 2)])
def test_init_and_forward_match_the_program(edges, arch, layers):
    spec, g, params = _port(arch, edges, layers)
    mod = reference.model(arch)
    ref_params = mod.init(7, N_U, N_I, D, layers, "cpu")
    for (n, a), (_, b) in zip(ref_train.leaves(params),
                              ref_train.leaves(ref_params)):
        assert torch.equal(a, b), n
    rg = ref_graph.Graph(torch.from_numpy(edges[0]), torch.from_numpy(edges[1]),
                         N_U, N_I)
    want_u, want_i = spec.forward(params, g, layers)
    got_u, got_i = mod.forward(ref_params, rg, layers)
    for got, want in ((got_u, want_u), (got_i, want_i)):
        scale = want.abs().max()
        assert float((got - want).abs().max() / scale) < 1e-5


@pytest.mark.parametrize("arch,layers", [("lightgcn", 3), ("ngcf", 2)])
def test_bpr_gradients_match_the_program(edges, arch, layers):
    spec, g, params = _port(arch, edges, layers)
    from repro_torch.core import bpr
    u, ip, ineg = (torch.from_numpy(a) for a in ref_train.batch(
        edges[0], edges[1], N_I, seed=5, size=256, step=0))
    live = [t.clone().requires_grad_(True) for _, t in ref_train.leaves(params)]
    flat = ref_train.unflatten(params, live)
    ue, ie = spec.forward(flat, g, layers)
    want = torch.autograd.grad(bpr.bpr_loss(ue, ie, u, ip, ineg, l2=1e-4), live)
    rg = ref_graph.Graph(torch.from_numpy(edges[0]), torch.from_numpy(edges[1]),
                         N_U, N_I)
    live2 = [t.detach().clone().requires_grad_(True) for t in live]
    ue2, ie2 = reference.model(arch).forward(ref_train.unflatten(params, live2),
                                             rg, layers)
    got = torch.autograd.grad(
        ref_train.bpr_loss(ue2, ie2, u, ip, ineg, 1e-4), live2)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < 1e-5


def test_batches_follow_the_programs_loader(edges):
    from repro_torch.data.loader import EdgeLoader
    u, i = edges
    loader = EdgeLoader(u, i, batch=512, seed=31)
    for step in range(3):
        lu, li = next(loader)
        ru, ri, rn = ref_train.batch(u, i, N_I, seed=31, size=512, step=step)
        assert np.array_equal(lu, ru) and np.array_equal(li, ri)
        neg = np.random.default_rng((31, step)).integers(0, N_I, 512)
        assert np.array_equal(rn, neg)


def test_topk_order_matches_the_program():
    from repro_torch.eval.topk import streaming_topk
    g = torch.Generator().manual_seed(3)
    ue = torch.randn(40, 8, generator=g)
    ie = torch.randn(300, 8, generator=g)
    ie[10:20] = ie[5]                  # ties broken by id
    ie[30] = 0.0                       # +0.0 scores
    ue[3] = 0.0                        # a user whose every score is 0
    ip = np.zeros(41, np.int64)
    rng = np.random.default_rng(0)
    seen = [np.sort(rng.choice(300, rng.integers(0, 40), replace=False))
            for _ in range(40)]
    ip[1:] = np.cumsum([len(s) for s in seen])
    items = np.concatenate(seen).astype(np.int64)
    want_s, want_i = streaming_topk(ue, ie, 20, seen_indptr=ip,
                                    seen_items=items, device="cpu")
    users = torch.arange(40)
    sc = ue @ ie.T
    mask = ref_topk.seen_mask(users, torch.from_numpy(ip),
                              torch.from_numpy(items), 300)
    ids, top = ref_topk.topk(sc, mask, 20)
    assert np.array_equal(ids.numpy(), want_i)
    assert np.array_equal(top.numpy(), want_s)


def test_order_key_is_ieee_total_order():
    vals = torch.tensor([float("nan"), float("inf"), 1.0, 0.0, -0.0, -1.0,
                         float("-inf"), -float("nan")])
    key = ref_topk.order_key(vals)
    assert key[0] > key[1] > key[2] > key[3] > key[5] > key[6] > key[7]
    assert key[3] == key[4]


def test_user_csr_holds_each_users_items(edges):
    u, i = edges
    ip, items = ref_topk.user_csr(torch.from_numpy(u), torch.from_numpy(i), N_U)
    for user in (0, 17, N_U - 1):
        got = np.sort(items[ip[user]:ip[user + 1]].numpy())
        assert np.array_equal(got, np.sort(i[u == user]))

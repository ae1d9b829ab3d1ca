"""DGCF (``pipeline.registry``'s ``dgcf``, ``core/dgcf.py``) against the
benchmark's plain reference (``perfbench/reference/dgcf.py``) on the CPU.

The port runs on ``BipartiteCSR``'s intent aggregation and agreement (the
plain routes of ``intent_spmm`` and ``intent_sddmm`` here) with a
written-out backward; the reference on the edge arrays with index_add and
autograd.  Both are float32.  Tolerances: the two add the same terms in
other orders (the reference's edge order, the port's CSR order, and the
agreement's and the gradients' sums differently grouped), which moves a
float32 result by a few ulps of its largest terms (~1e-6 relative here);
each limit below sits at 1e-5 or 1e-4, and the same comparison of a
bfloat16 forward (``test_a_bfloat16_forward_fails_the_tolerances``) reads
~1e-2, so a forward in the next precision down fails every one.
"""
import numpy as np
import pytest
import torch

from perfbench.data import graph as gen
from perfbench.reference import dgcf as ref_dgcf
from perfbench.reference import graph as ref_graph
from perfbench.reference import train as ref_train
from repro_torch.api import Experiment
from repro_torch.core import bpr
from repro_torch.core import dgcf
from repro_torch.data.synth import InteractionData
from repro_torch.kernels import ops, ref
from repro_torch.pipeline.registry import MODELS, _lightgcn_forward, get_model
from repro_torch.pipeline.sparse import BipartiteCSR

N_U, N_I, N_E, D, K = 300, 200, 4000, 64, 4
# float32 in two orders of adds (module doc): embeddings relative to the
# largest entry, loss relative, gradients relative in the norm
EMB_TOL = LOSS_TOL = GRAD_TOL = 1e-5
# Adam divides by sqrt(v): a coordinate whose gradient is ~0 moves by a
# ratio of two round-off terms, so the change of the parameters over the
# steps is held in the norm at 1e-4
UPDATE_TOL = 1e-4


@pytest.fixture(scope="module")
def graph():
    g = gen.generate(N_U, N_I, N_E, seed=2_147_483_651, device="cpu")
    u, i = g.train_user.numpy(), g.train_item.numpy()
    csr = BipartiteCSR(u, i, N_U, N_I, device="cpu")
    rg = ref_graph.Graph(torch.from_numpy(u), torch.from_numpy(i), N_U, N_I)
    return u, i, csr, rg


def _params(seed=7, dim=D):
    return ref_dgcf.init(seed, N_U, N_I, dim, 1, "cpu")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _norm_rel(got, want):
    return float((got - want).norm() / want.norm())


def test_registry_binds_the_published_setting_and_lightgcns_draw():
    spec = get_model("dgcf")
    assert (dgcf.N_FACTORS, dgcf.N_ITERATIONS) == (4, 2)
    assert (ref_dgcf.N_FACTORS, ref_dgcf.N_ITERATIONS) == (4, 2)
    assert spec.forward.keywords == {"n_factors": 4, "n_iterations": 2}
    assert not spec.materializes_messages and not spec.concat_layers
    a = spec.init(5, N_U, N_I, D, 1, device="cpu")
    b = MODELS["lightgcn"].init(5, N_U, N_I, D, 1, device="cpu")
    c = ref_dgcf.init(5, N_U, N_I, D, 1, "cpu")
    for k in ("user_embed", "item_embed"):
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])


@pytest.mark.parametrize("n_iterations", [1, 2])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_forward_loss_and_gradients_match_the_reference(graph, n_layers,
                                                         n_iterations):
    u, i, csr, rg = graph
    p = _params()
    users, pos, neg = (torch.from_numpy(a) for a in ref_train.batch(
        u, i, N_I, seed=11, size=512, step=0))
    outs = []
    for fwd, g in ((dgcf.forward, csr), (ref_dgcf.forward, rg)):
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        ue, ie = fwd(live, g, n_layers, n_factors=K,
                     n_iterations=n_iterations)
        loss = bpr.bpr_loss(ue, ie, users, pos, neg, l2=1e-4)
        grads = torch.autograd.grad(loss, [live["user_embed"],
                                           live["item_embed"]])
        outs.append((ue.detach(), ie.detach(), loss.detach(), grads))
    (pu, pi, pl, pg), (ru, ri, rl, rgr) = outs
    assert _rel(pu, ru) < EMB_TOL and _rel(pi, ri) < EMB_TOL
    assert abs(float(pl - rl)) / abs(float(rl)) < LOSS_TOL
    for a, b in zip(pg, rgr):
        assert _norm_rel(a, b) < GRAD_TOL


def test_one_iteration_one_layer_is_lightgcn(graph):
    """T = 1: P = 1/K and deg = degree/K, so the weight of an edge is
    (1/K)·sqrt(K/d_u)·sqrt(K/d_i) = 1/sqrt(d_u d_i): LightGCN's layer,
    rounded in another order (relative 1e-6)."""
    _, _, csr, _ = graph
    p = _params()
    got = dgcf.forward(p, csr, 1, n_factors=K, n_iterations=1)
    want = _lightgcn_forward(p, csr, 1)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-6


def test_a_bfloat16_forward_fails_the_tolerances(graph):
    _, _, csr, rg = graph
    p = _params()
    want_u, want_i = dgcf.forward(p, csr, 1)
    low = {k: v.to(torch.bfloat16) for k, v in p.items()}
    got_u, got_i = ref_dgcf.forward(low, rg, 1)
    assert min(_rel(got_u.float(), want_u), _rel(got_i.float(), want_i)) \
        > 10 * EMB_TOL


def test_three_adam_steps_through_run_fit_follow_the_reference(graph):
    """``lightgcn-smoke`` built with ``model.arch`` dgcf, one 512-row
    microbatch a step, lr 1e-3: Run.fit's losses, the first gradient (Adam's
    first moment after one step) and the change of each table over 3
    steps, against the reference trainer from the same init and seed."""
    u, i, _, rg = graph
    seed, batch = 2_147_483_659, 512
    exp = Experiment.from_preset("lightgcn-smoke").override({
        "model.arch": "dgcf", "model.embed_dim": D, "model.n_layers": 1,
        "plan.base_batch": batch, "plan.target_batch": batch,
        "plan.microbatch": batch, "plan.warmup_epochs": 0, "base_lr": 1e-3,
        "l2": 1e-4, "seed": seed})
    run = exp.build(train=InteractionData(u.copy(), i.copy(), N_U, N_I),
                    holdout=None, device="cpu")
    p0 = {k: v.detach().clone() for k, v in run.params.items()}
    losses = list(run.fit(steps=1).losses)
    m = {k: v / (1 - ref_train.B1) for k, v in run.state["opt"]["m"].items()}
    losses += run.fit(steps=2).losses
    want = ref_train.follow(ref_dgcf, ref_dgcf.init(seed, N_U, N_I, D, 1,
                                                    "cpu"),
                            rg, u, i, n_layers=1, batch_size=batch, lr=1e-3,
                            l2=1e-4, seed=seed, steps=3)
    for a, b in zip(losses, want.losses, strict=True):
        assert abs(a - b) / abs(b) < LOSS_TOL
    for k in ("user_embed", "item_embed"):
        assert torch.equal(p0[k], ref_dgcf.init(seed, N_U, N_I, D, 1,
                                                "cpu")[k])
        g = float(m[k].double().norm())
        assert abs(g - want.grad_norms[k]) / want.grad_norms[k] < GRAD_TOL
        change = float((run.params[k].detach() - p0[k]).double().norm())
        assert abs(change - want.change_norms[k]) / want.change_norms[k] \
            < UPDATE_TOL


# ------------------------------------------------- the two operations
def _tiny_csr(rng, n_rows, n_src, e):
    from repro_torch.kernels.spmm import build_csr_by_dst
    dst = rng.integers(0, n_rows - 2, e)       # the last two rows empty
    indptr, src, _ = build_csr_by_dst(dst, rng.integers(0, n_src, e), n_rows)
    return torch.from_numpy(indptr).long(), torch.from_numpy(src)


@pytest.mark.parametrize("d,k", [(8, 4), (12, 3), (6, 1)])
def test_intent_plain_routes_match_a_dense_formula(d, k):
    rng = np.random.default_rng(d + k)
    n, n_src, e = 9, 7, 40
    indptr, src = _tiny_csr(rng, n, n_src, e)
    w = torch.from_numpy(rng.standard_normal((e, k)))
    x = torch.from_numpy(rng.standard_normal((n_src, d)))
    a = torch.from_numpy(rng.standard_normal((n, d)))
    dk = d // k
    want_out = torch.zeros((n, d), dtype=torch.float64)
    want_s = torch.zeros((e, k), dtype=torch.float64)
    for r in range(n):
        for j in range(int(indptr[r]), int(indptr[r + 1])):
            for q in range(k):
                cols = slice(q * dk, (q + 1) * dk)
                want_out[r, cols] += w[j, q] * x[int(src[j]), cols]
                want_s[j, q] = (a[r, cols] * x[int(src[j]), cols]).sum()
    got = ops.intent_spmm(w, x, indptr, src, n)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want_out, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ops.intent_sddmm(a, x, indptr, src, k),
                               want_s, rtol=1e-12, atol=1e-12)
    # float32 in: the same sums, each rounded as the kernel rounds it
    got32 = ref.intent_spmm_ref(w.float(), x.float(), indptr, src, n)
    assert got32.dtype == torch.float32
    torch.testing.assert_close(got32.double(), want_out, rtol=1e-5,
                               atol=1e-5)


def _graph64(seed=0, n_u=12, n_i=9, e=60):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_u - 1, e)             # the last user has no edge
    i = rng.integers(0, n_i, e)
    return BipartiteCSR(u, i, n_u, n_i, device="cpu"), rng


@pytest.mark.parametrize("side", ["user", "item"])
def test_intent_aggregation_backward_is_its_gradient(side):
    g, rng = _graph64()
    n_dst, n_src = (g.n_users, g.n_items) if side == "user" \
        else (g.n_items, g.n_users)
    w = torch.from_numpy(rng.random((g.n_edges, K))).requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal((n_src, 8))).requires_grad_(True)
    fn = g.intent_agg_user if side == "user" else g.intent_agg_item
    assert fn(w, x).shape == (n_dst, 8)
    assert torch.autograd.gradcheck(fn, (w, x))


@pytest.mark.parametrize("side", ["user", "item"])
def test_intent_agreement_backward_is_its_gradient(side):
    g, rng = _graph64(1)
    n_row, n_src = (g.n_users, g.n_items) if side == "user" \
        else (g.n_items, g.n_users)
    a = torch.from_numpy(rng.standard_normal((n_row, 8))).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((n_src, 8))).requires_grad_(True)
    fn = g.intent_agree_user if side == "user" else g.intent_agree_item
    assert fn(a, b, K).shape == (g.n_edges, K)
    assert torch.autograd.gradcheck(lambda a_, b_: fn(a_, b_, K), (a, b))


@pytest.mark.parametrize("side", ["user", "item"])
def test_routing_weights_backward_is_its_gradient(side):
    """The written-out backward of softmax, degrees and deg^(-1/2)."""
    g, rng = _graph64(2)
    s = torch.from_numpy(rng.standard_normal((g.n_edges, K)))
    s.requires_grad_(True)
    p, r = dgcf._weights(g, s, side)
    assert torch.allclose(p.sum(1), torch.ones(g.n_edges, dtype=p.dtype))
    if side == "user":
        assert float(r[-1].detach().abs().sum()) == 0.0   # no edge: r = 0
    assert torch.autograd.gradcheck(lambda s_: dgcf._weights(g, s_, side),
                                    (s,))


def test_the_whole_forward_backward_is_its_gradient():
    """Two layers of two iterations, float64, through every written-out
    backward and the routing carried from layer to layer."""
    g, rng = _graph64(3, n_u=8, n_i=6, e=30)
    xu = torch.from_numpy(rng.standard_normal((g.n_users, 8)))
    xi = torch.from_numpy(rng.standard_normal((g.n_items, 8)))

    def fwd(a, b):
        return dgcf.forward({"user_embed": a, "item_embed": b}, g, 2,
                            n_factors=K, n_iterations=2)

    assert torch.autograd.gradcheck(fwd, (xu.requires_grad_(True),
                                          xi.requires_grad_(True)))


def test_bad_widths_are_refused():
    g, _ = _graph64()
    p = {"user_embed": torch.zeros(g.n_users, 6),
         "item_embed": torch.zeros(g.n_items, 6)}
    with pytest.raises(ValueError, match="intents must divide"):
        dgcf.forward(p, g, 1, n_factors=4)
    with pytest.raises(ValueError, match="n_iterations"):
        dgcf.forward(p, g, 1, n_factors=3, n_iterations=0)

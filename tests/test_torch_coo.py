"""The port's seed COO path on the CPU against the reference: graph
containers (host arrays byte for byte), the generalized sparse ops, every
NGCF dataflow level O0-O3, the NGCF and LightGCN COO forwards from
carried-over params, COO against the port's CSR registry, BPR gradients
through O1 and O3, and a 5-step Adam trajectory of the NGCF/LightGCN
FULL cells' training step (reference ``launch/cells.py:739-776``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpr as jbpr
from repro.core import graph as jgraph
from repro.core import lightgcn as jlightgcn
from repro.core import message_passing as jmp
from repro.core import ngcf as jngcf
from repro.core import sparse_ops as jsparse
from repro.data import synth as jsynth
from repro.optim import adam as jadam
from repro_torch.convert import params_from_jax
from repro_torch.core import graph, lightgcn, message_passing, ngcf, sparse_ops
from repro_torch.core.train_step import bpr_value_and_grad, full_graph_step
from repro_torch.kernels import launch_counts
from repro_torch.optim import adam
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.pipeline import BipartiteCSR, get_model

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)          # fp32 sums in another order
LEVEL_TOL = dict(rtol=2e-4, atol=2e-5)    # tests/test_core.py across levels
COEFF_TOL = dict(rtol=1e-6)               # XLA-CPU rsqrt vs torch.rsqrt


def _data(n_users=60, n_items=45, edges=600, seed=0):
    data = jsynth.generate_bipartite(n_users, n_items, edges, seed=seed)
    train, _ = jsynth.train_test_split(data)
    return data, train


def _graphs(train, data, e_pad=None):
    jg = jgraph.bipartite_from_numpy(train.user, train.item, data.n_users,
                                     data.n_items, e_pad)
    g = graph.bipartite_from_numpy(train.user, train.item, data.n_users,
                                   data.n_items, e_pad, device="cpu")
    return jg, g


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _leaves(tree):
    """Leaves with dict keys sorted, as jax.tree.leaves orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [_np(tree)]


def _close_to_scale(got, want, rtol=1e-5):
    """rtol, with atol rtol x the table's largest magnitude: deep NGCF
    layers and their gradients sum terms of the table's scale in another
    order (and XLA's CPU matmul rounds otherwise than torch's), so an
    entry that cancels to a small value keeps an error of that scale."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------------------------ graph
def test_graph_host_arrays_are_byte_equal():
    data, train = _data()
    e_pad = train.n_edges + 37
    jg, g = _graphs(train, data, e_pad)
    for a, b in ((g.user, jg.user), (g.item, jg.item),
                 (g.edge_mask, jg.edge_mask)):
        assert _np(a).dtype == _np(b).dtype
        np.testing.assert_array_equal(_np(a), _np(b))
    assert (g.n_users, g.n_items, g.n_edges, g.e_pad, g.n_nodes) == (
        jg.n_users, jg.n_items, jg.n_edges, jg.e_pad, jg.n_nodes)
    hg, jhg = g.as_homogeneous(), jg.as_homogeneous()
    for a, b in ((hg.src, jhg.src), (hg.dst, jhg.dst),
                 (hg.edge_mask, jhg.edge_mask)):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert _np(a).dtype == _np(b).dtype
    assert (hg.n_nodes, hg.n_edges, hg.e_pad) == (jhg.n_nodes, jhg.n_edges,
                                                 jhg.e_pad)
    rg, jrg = hg.reverse(), jhg.reverse()
    np.testing.assert_array_equal(_np(rg.src), _np(jrg.src))
    np.testing.assert_array_equal(_np(rg.dst), _np(jrg.dst))
    s, d, m = graph.pad_edges(train.user, train.item, e_pad)
    for a, b in zip((s, d, m), jgraph.pad_edges(train.user, train.item,
                                                e_pad)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="exceed pad budget"):
        graph.pad_edges(train.user, train.item, train.n_edges - 1)
    fg = graph.from_numpy(train.user, train.item, data.n_users, e_pad,
                          device="cpu")
    jfg = jgraph.from_numpy(train.user, train.item, data.n_users, e_pad)
    for a, b in ((fg.src, jfg.src), (fg.dst, jfg.dst),
                 (fg.edge_mask, jfg.edge_mask)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(graph.to_csr(train.user, train.item, data.n_users),
                    jgraph.to_csr(train.user, train.item, data.n_users)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_graph_degrees_and_coefficients():
    data, train = _data(seed=1)
    jg, g = _graphs(train, data, train.n_edges + 9)
    hg, jhg = g.as_homogeneous(), jg.as_homogeneous()
    np.testing.assert_array_equal(
        _np(graph.degrees(hg.src, hg.edge_mask, hg.n_nodes)),
        _np(jgraph.degrees(jhg.src, jhg.edge_mask, jhg.n_nodes)))
    np.testing.assert_allclose(_np(graph.sym_norm_coeff(hg)),
                               _np(jgraph.sym_norm_coeff(jhg)), **COEFF_TOL)
    c = _np(message_passing.bipartite_sym_coeff(g))
    np.testing.assert_allclose(c, _np(jmp.bipartite_sym_coeff(jg)),
                               **COEFF_TOL)
    np.testing.assert_array_equal(c[~_np(g.edge_mask)], 0.0)


# ------------------------------------------------------------- sparse ops
def _edges(seed, n, e, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n // 2, e).astype(np.int32)   # empty rows exist
    mask = rng.random(e) > 0.25
    return rng, x, src, dst, mask


@pytest.mark.parametrize("op", ["mul", "add", "dot", "copy"])
def test_sparse_sddmm_matches_reference(op):
    _, x, src, dst, mask = _edges(1, 20, 70, 12)
    y = x[::-1].copy()
    got = sparse_ops.sddmm(op, T(x), T(y), T(src), T(dst), T(mask))
    want = jsparse.sddmm(op, jnp.asarray(x), jnp.asarray(y), jnp.asarray(src),
                         jnp.asarray(dst), jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("vector", [True, False])
def test_sparse_spmm_matches_reference(reduce, vector):
    _, x, src, dst, mask = _edges(2, 30, 90, 7)
    msg = x[src] if vector else x[src, 0].copy()
    got = sparse_ops.spmm(reduce, T(msg), T(dst), 30, T(mask))
    want = jsparse.spmm(reduce, jnp.asarray(msg), jnp.asarray(dst), 30,
                        jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    empty = np.bincount(dst[mask], minlength=30) == 0
    assert empty.any()
    np.testing.assert_array_equal(_np(got)[empty], 0.0)


def test_sparse_spmm_max_maps_every_nonfinite_maximum_to_zero():
    """Empty rows, a genuine +inf message and a NaN message all give 0
    (reference sparse_ops.py:66); -inf messages beside finite ones lose."""
    msg = np.array([[1.0, 2.0], [np.inf, -1.0], [np.nan, 3.0],
                    [-np.inf, 5.0], [4.0, -np.inf], [7.0, 7.0]], np.float32)
    dst = np.array([0, 0, 1, 2, 2, 3], np.int32)
    mask = np.array([True, True, True, True, True, False])
    got = _np(sparse_ops.spmm("max", T(msg), T(dst), 5, T(mask)))
    want = _np(jsparse.spmm("max", jnp.asarray(msg), jnp.asarray(dst), 5,
                            jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0.0, 2.0], [0.0, 3.0], [4.0, 5.0],
                                        [0.0, 0.0], [0.0, 0.0]])


def test_sparse_edge_softmax_and_copy_sum_match_reference():
    rng, x, src, dst, mask = _edges(3, 25, 80, 9)
    scores = rng.standard_normal(80).astype(np.float32) * 4
    got = sparse_ops.edge_softmax(T(scores), T(dst), 25, T(mask))
    want = jsparse.edge_softmax(jnp.asarray(scores), jnp.asarray(dst), 25,
                                jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_array_equal(_np(got)[~mask], 0.0)
    coeff = rng.standard_normal(80).astype(np.float32)
    for c in (None, coeff):
        got = sparse_ops.gspmm_copy_sum(T(x), T(src), T(dst), 25, T(mask),
                                        None if c is None else T(c))
        want = jsparse.gspmm_copy_sum(jnp.asarray(x), jnp.asarray(src),
                                      jnp.asarray(dst), 25, jnp.asarray(mask),
                                      None if c is None else jnp.asarray(c))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------- NGCF levels
def _ngcf_case(seed=0, d=16, layers=2, e_pad=None):
    data, train = _data(seed=seed)
    jg, g = _graphs(train, data, e_pad)
    jp = jngcf.init_params(jax.random.PRNGKey(seed), data.n_users,
                           data.n_items, d, layers)
    return data, train, jg, g, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_ngcf_level_matches_reference_level(level):
    data, train, jg, g, jp, p = _ngcf_case(e_pad=None)
    jg = jgraph.bipartite_from_numpy(train.user, train.item, data.n_users,
                                     data.n_items, train.n_edges + 11)
    g = graph.bipartite_from_numpy(train.user, train.item, data.n_users,
                                   data.n_items, train.n_edges + 11,
                                   device="cpu")
    args = (jp["user_embed"], jp["item_embed"], jp["w1"][0], jp["w2"][0])
    jhu, jhi = jmp.ngcf_propagate_bipartite(jg, *args, opt_level=level)
    hu, hi = message_passing.ngcf_propagate_bipartite(
        g, p["user_embed"], p["item_embed"], p["w1"][0], p["w2"][0],
        opt_level=level)
    np.testing.assert_allclose(_np(hu), _np(jhu), **TOL)
    np.testing.assert_allclose(_np(hi), _np(jhi), **TOL)


def test_ngcf_levels_on_integer_inputs_are_bitwise():
    """Integer-valued embeddings and weights: every sum and product is
    exact, so all four levels and the reference agree bit for bit."""
    data, train, jg, g, _, _ = _ngcf_case(seed=2)
    rng = np.random.default_rng(0)
    xu = rng.integers(-2, 3, (data.n_users, 8)).astype(np.float32)
    xi = rng.integers(-2, 3, (data.n_items, 8)).astype(np.float32)
    w1 = rng.integers(-2, 3, (8, 8)).astype(np.float32)
    w2 = rng.integers(-2, 3, (8, 8)).astype(np.float32)
    want = jmp.ngcf_propagate_bipartite(jg, *map(jnp.asarray, (xu, xi, w1, w2)),
                                        opt_level=3)
    for level in (0, 1, 2, 3):
        got = message_passing.ngcf_propagate_bipartite(
            g, *map(T, (xu, xi, w1, w2)), opt_level=level)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("pair", [(0, 3), (1, 3), (2, 3), (0, 1)])
def test_ngcf_levels_agree_with_each_other(pair):
    _, _, _, g, _, p = _ngcf_case(seed=3, layers=3)
    a, b = (ngcf.forward(p, g, opt_level=lvl) for lvl in pair)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), **LEVEL_TOL)


# ---------------------------------------------------------- forwards
@pytest.mark.parametrize("level", [0, 1, 3])
def test_ngcf_forward_from_carried_params(level):
    _, _, jg, g, jp, p = _ngcf_case(seed=4, layers=3)
    ju, ji = jngcf.forward(jp, jg, opt_level=level)
    u, i = ngcf.forward(p, g, opt_level=level)
    assert ngcf.n_layers(p) == jngcf.n_layers(jp) == 3
    assert u.shape == ju.shape and i.shape == ji.shape
    _close_to_scale(u, ju)
    _close_to_scale(i, ji)


@pytest.mark.parametrize("layers", [1, 3])
def test_lightgcn_forward_from_carried_params(layers):
    data, train = _data(seed=5)
    jg, g = _graphs(train, data, train.n_edges + 5)
    jp = jlightgcn.init_params(jax.random.PRNGKey(5), data.n_users,
                               data.n_items, 16)
    ju, ji = jlightgcn.forward(jp, jg, n_layers=layers)
    u, i = lightgcn.forward(params_from_jax(jp, device="cpu"), g,
                            n_layers=layers)
    np.testing.assert_allclose(_np(u), _np(ju), **TOL)
    np.testing.assert_allclose(_np(i), _np(ji), **TOL)


def test_forwards_are_padding_invariant():
    """Padded edges (masked, pointing at node 0) change nothing."""
    data, train = _data(seed=6)
    _, g0 = _graphs(train, data)
    _, g1 = _graphs(train, data, train.n_edges + 64)
    p = params_from_jax(jngcf.init_params(jax.random.PRNGKey(6), data.n_users,
                                          data.n_items, 16, 2), device="cpu")
    for level in (0, 1, 2, 3):
        for a, b in zip(ngcf.forward(p, g0, opt_level=level),
                        ngcf.forward(p, g1, opt_level=level)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(lightgcn.forward(p, g0, 2), lightgcn.forward(p, g1, 2)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_coo_matches_the_ports_csr_registry():
    """tests/test_pipeline.py:24-47's tolerances: LightGCN rtol 1e-5 /
    atol 1e-6; NGCF (O3 against the fused Hadamard route) rtol 2e-4 /
    atol 2e-5."""
    data, train = _data(seed=7)
    _, g = _graphs(train, data)
    g_csr = BipartiteCSR(train.user, train.item, data.n_users, data.n_items,
                         device="cpu")
    lp = params_from_jax(jlightgcn.init_params(
        jax.random.PRNGKey(0), data.n_users, data.n_items, 16), device="cpu")
    for a, b in zip(get_model("lightgcn").forward(lp, g_csr, 2),
                    lightgcn.forward(lp, g, n_layers=2)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    npar = params_from_jax(jngcf.init_params(
        jax.random.PRNGKey(1), data.n_users, data.n_items, 16, 2),
        device="cpu")
    for a, b in zip(get_model("ngcf").forward(npar, g_csr, 2),
                    ngcf.forward(npar, g, opt_level=3)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------- training
def _bpr_batch(train, data, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return jbpr.sample_bpr_batch(rng, train.user, train.item, data.n_items, n)


@pytest.mark.parametrize("level", [1, 3])
def test_ngcf_bpr_grads_match_jax_value_and_grad(level):
    data, train, jg, g, jp, p = _ngcf_case(seed=8, layers=2, e_pad=None)
    bu, bi, bn = _bpr_batch(train, data)

    def jloss(params):
        ue, ie = jngcf.forward(params, jg, opt_level=level)
        return jbpr.bpr_loss(ue, ie, jnp.asarray(bu), jnp.asarray(bi),
                             jnp.asarray(bn))

    jl, jgr = jax.value_and_grad(jloss)(jp)
    loss, grads = bpr_value_and_grad(
        lambda q: ngcf.forward(q, g, opt_level=level), p,
        *(T(a).long() for a in (bu, bi, bn)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got, want = _leaves(grads), _leaves(jgr)
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        _close_to_scale(a, b)


def test_ngcf_grads_at_o2_launch_nothing_on_the_cpu():
    """O2 and O3 route their sddmm by the tensors' device: on the CPU the
    plain version, so no kernel launch is counted."""
    data, train, _, g, _, p = _ngcf_case(seed=9)
    bu, bi, bn = (T(a).long() for a in _bpr_batch(train, data))
    before = launch_counts()
    l2, g2 = bpr_value_and_grad(lambda q: ngcf.forward(q, g, opt_level=2),
                                p, bu, bi, bn)
    l3, g3 = bpr_value_and_grad(lambda q: ngcf.forward(q, g, opt_level=3),
                                p, bu, bi, bn)
    assert launch_counts() == before
    assert float(l2) == float(l3)
    for a, b in zip(tree_leaves(g2), tree_leaves(g3)):
        _close_to_scale(a, b)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_ngcf_levels_1_to_3_route_sddmm_by_impl(level):
    """Levels 1-3 share the reference's routing: each follows ``impl``,
    so ``impl='cuda'`` on CPU tensors raises at every one of them (no
    level overrides the caller's choice), while level 0 has no sddmm."""
    _, _, _, g, _, p = _ngcf_case(seed=9)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ngcf.forward(p, g, opt_level=level, impl="cuda")
    for a, b in zip(ngcf.forward(p, g, opt_level=level, impl="torch"),
                    ngcf.forward(p, g, opt_level=level)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,layers", [("ngcf", 2), ("lightgcn", 3)])
def test_cells_step_adam_trajectory_matches_reference(arch, layers):
    """Five steps of the cells' step — forward (NGCF at O3), BPR, Adam —
    from the same params on the same batches; loss to rtol 1e-5 and
    params to rtol 1e-4 / atol 1e-6 after every step."""
    data, train = _data(seed=10)
    jg, g = _graphs(train, data, train.n_edges + 13)
    key = jax.random.PRNGKey(10)
    if arch == "ngcf":
        jp = jngcf.init_params(key, data.n_users, data.n_items, 16, layers)
    else:
        jp = jlightgcn.init_params(key, data.n_users, data.n_items, 16)
    jopt, opt = jadam(1e-2), adam(1e-2)

    @jax.jit
    def jstep(params, opt_state, bu, bi, bn):
        def loss_fn(pp):
            if arch == "ngcf":
                ue, ie = jngcf.forward(pp, jg, opt_level=3)
            else:
                ue, ie = jlightgcn.forward(pp, jg, n_layers=layers)
            return jbpr.bpr_loss(ue, ie, bu, bi, bn)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state = jopt.update(grads, opt_state, params)
        return params, opt_state, loss

    if arch == "ngcf":
        step = full_graph_step(lambda q: ngcf.forward(q, g, opt_level=3), opt)
    else:
        step = full_graph_step(
            lambda q: lightgcn.forward(q, g, n_layers=layers), opt)
    p = params_from_jax(jp, device="cpu")
    js, s = jopt.init(jp), opt.init(p)
    for k in range(5):
        bu, bi, bn = _bpr_batch(train, data, seed=k)
        jp, js, jl = jstep(jp, js, *map(jnp.asarray, (bu, bi, bn)))
        p, s, loss = step(p, s, *(T(a).long() for a in (bu, bi, bn)))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for a, b in zip(_leaves(p), _leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

"""The port's CTR and sequential pool (``repro_torch.models.recsys_models``)
against ``repro.models.recsys_models``, over the four archs (deepfm,
xdeepfm, dlrm_rm2, bert4rec) at their SMOKE configs: configs, the init's
layout, ``convert.params_from_jax`` on each tree, every forward, loss and
gradient from the reference's initial params carried across through
numpy, the interactions, ``rowwise_adagrad_update`` with duplicate ids,
``dlrm_retrieve`` against the forward with the candidate substituted, and
BERT4Rec's encode, full and sampled losses, serve and retrieve.

Tolerances: forwards and losses rtol 1e-5 (atol 1e-6); gradients within
1e-4 relative in the norm per leaf; the retrieval identity at the
reference's own rtol 1e-4, atol 1e-5 (``tests/test_arch_smoke.py:162``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import recsys_models as jrm
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core.train_step import value_and_grad
from repro_torch.models import recsys_models as rm
from repro_torch.optim.optimizers import tree_paths
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
ARCHS = ["deepfm", "xdeepfm", "dlrm_rm2", "bert4rec"]
INIT = {"deepfm": ("deepfm_init", "deepfm_forward"),
        "xdeepfm": ("xdeepfm_init", "xdeepfm_forward"),
        "dlrm_rm2": ("dlrm_init", "dlrm_forward"),
        "bert4rec": ("bert4rec_init", "bert4rec_encode")}
B = 16


def _jpaths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _setup(arch, seed=0):
    cfg, jcfg = configs.get(arch).SMOKE, jconfigs.get(arch).SMOKE
    jp = getattr(jrm, INIT[arch][0])(jcfg, jax.random.PRNGKey(seed))
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, p


def _feats(arch, cfg, seed=0):
    """numpy inputs of the arch's forward, labels last."""
    rng = np.random.default_rng(seed)
    if arch == "bert4rec":
        s, m, n = cfg.seq_len, 3, 8
        seq = rng.integers(0, cfg.n_items, (B, s)).astype(np.int32)
        smask = np.ones((B, s), bool)
        smask[::3, -4:] = False                     # padded keys
        mpos = rng.integers(0, s, (B, m)).astype(np.int32)
        labels = rng.integers(0, cfg.n_items, (B, m)).astype(np.int32)
        negs = rng.integers(0, cfg.n_items, (B, m, n)).astype(np.int32)
        return [seq, smask, mpos, labels, negs]
    ids = rng.integers(0, cfg.vocab, (B, cfg.n_sparse)).astype(np.int32)
    labels = rng.integers(0, 2, B).astype(np.float32)
    if arch == "dlrm_rm2":
        dense = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
        return [dense, ids, labels]
    return [ids, labels]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_grads(grads, jgrads):
    got, want = tree_paths(grads), _jpaths(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, jg) in zip(got, want):
        assert _rel(g.numpy(), jg) <= GRAD_RTOL, path


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    mod, jmod = configs.get(arch), jconfigs.get(arch)
    for attr in ("FAMILY", "OPTIMIZER"):
        assert getattr(mod, attr) == getattr(jmod, attr)
    for variant in ("FULL", "SMOKE"):
        assert dataclasses.asdict(getattr(mod, variant)) == \
            dataclasses.asdict(getattr(jmod, variant))
    if arch == "bert4rec":
        assert (mod.N_NEGATIVES, mod.N_MASKED) == \
            (jmod.N_NEGATIVES, jmod.N_MASKED)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_reference(arch):
    """Same paths, shapes and zero/one leaves as the reference's init; the
    same seed gives the same bits, another seed other bits."""
    cfg, _, jp, _ = _setup(arch)
    init = getattr(rm, INIT[arch][0])
    p = init(cfg, 0, device="cpu")
    got, want = tree_paths(p), _jpaths(jp)
    assert [x for x, _ in got] == [x for x, _ in want]
    for (path, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        if not a.std():                  # biases, layer-norm weights
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            assert 0.5 < float(t.std()) / float(a.std()) < 2.0, path
    again = tree_paths(init(cfg, 0, device="cpu"))
    other = tree_paths(init(cfg, 1, device="cpu"))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, again))
    big = max(range(len(got)), key=lambda i: got[i][1].numel())
    assert not torch.equal(got[big][1], other[big][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_takes_the_tree(arch):
    """The 0-d ``bias``, the ``cin`` list, the ``mlp``/``bot``/``top``
    lists of dicts and the ``blocks`` list of dicts carry across bit for
    bit, with their layout."""
    _, _, jp, p = _setup(arch)
    got, want = tree_paths(p), _jpaths(jp)
    assert [x for x, _ in got] == [x for x, _ in want]
    for (path, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape, path
        np.testing.assert_array_equal(t.numpy(), a)
    for key in ("cin", "mlp", "bot", "top", "blocks"):
        if key in p:
            assert isinstance(p[key], list)
    if "bias" in p:
        assert p["bias"].dim() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, jp, p = _setup(arch)
    feats = _feats(arch, cfg)
    fwd, jfwd = getattr(rm, INIT[arch][1]), getattr(jrm, INIT[arch][1])
    n_in = 2 if arch in ("bert4rec", "dlrm_rm2") else 1
    got = fwd(cfg, p, *[torch.from_numpy(f) for f in feats[:n_in]])
    want = jfwd(jcfg, jp, *[jnp.asarray(f) for f in feats[:n_in]])
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The legacy trainer's objective (BCE of the forward), or BERT4Rec's
    sampled cloze loss, and every param's gradient."""
    cfg, jcfg, jp, p = _setup(arch)
    feats = _feats(arch, cfg, seed=1)
    t = [torch.from_numpy(f) for f in feats]
    j = [jnp.asarray(f) for f in feats]
    if arch == "bert4rec":
        loss, grads = value_and_grad(
            lambda q: rm.bert4rec_sampled_loss(cfg, q, *t), p)
        jloss, jgrads = jax.value_and_grad(
            lambda q: jrm.bert4rec_sampled_loss(jcfg, q, *j))(jp)
    else:
        fwd, jfwd = getattr(rm, INIT[arch][1]), getattr(jrm, INIT[arch][1])
        loss, grads = value_and_grad(
            lambda q: rm.bce_loss(fwd(cfg, q, *t[:-1]), t[-1]), p)
        jloss, jgrads = jax.value_and_grad(
            lambda q: jrm.bce_loss(jfwd(jcfg, q, *j[:-1]), j[-1]))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _assert_grads(grads, jgrads)


@pytest.mark.parametrize("shape", [(3, 11, 4), (5, 7)])
def test_lookup_fields_and_bce_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    tables = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, shape[1], (9, shape[0])).astype(np.int32)
    ids[0] = ids[1]                                  # duplicate rows
    got = rm.lookup_fields(torch.from_numpy(tables), torch.from_numpy(ids))
    want = jrm.lookup_fields(jnp.asarray(tables), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = np.array([-120.0, -3.5, -1e-3, 0.0, 2.0, 40.0, 95.0],
                      np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0, 1], np.float32)
    _close(rm.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
           jrm.bce_loss(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_matches_reference(final_act):
    key = jax.random.PRNGKey(3)
    jp = jrm._mlp_params(key, (6, 9, 4))
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(3).standard_normal((5, 6)).astype(np.float32)
    _close(rm._mlp(p, torch.from_numpy(x), final_act),
           jrm._mlp(jp, jnp.asarray(x), final_act))


@pytest.mark.parametrize("op", ["fm", "cin", "dot"])
def test_interactions_match_reference(op):
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((6, 5, 4)).astype(np.float32)
    if op == "fm":
        got = rm.fm_interaction(torch.from_numpy(emb))
        want = jrm.fm_interaction(jnp.asarray(emb))
    elif op == "cin":
        ws = [rng.standard_normal((h, hp, 5)).astype(np.float32)
              for h, hp in ((7, 5), (3, 7))]
        got = rm.cin([torch.from_numpy(w) for w in ws], torch.from_numpy(emb))
        want = jrm.cin([jnp.asarray(w) for w in ws], jnp.asarray(emb))
        assert tuple(got.shape) == (6, 10)
    else:
        got = rm.dot_interaction(torch.from_numpy(emb))
        want = jrm.dot_interaction(jnp.asarray(emb))
        # row-major strictly-lower pairs: (1,0), (2,0), (2,1), (3,0), ...
        np.testing.assert_allclose(got[:, 2].numpy(),
                                   (emb[:, 2] * emb[:, 1]).sum(-1),
                                   rtol=RTOL)
    _close(got, want)


@pytest.mark.parametrize("dup", ["none", "some", "all"])
def test_rowwise_adagrad_update_matches_reference(dup):
    """Every duplicate id's squared gradient reaches ``acc`` before any
    row reads it; tables and accumulator are updated in place."""
    rng = np.random.default_rng(11)
    f, v, d, b = 3, 10, 4, 12
    tables = rng.standard_normal((f, v, d)).astype(np.float32)
    acc = rng.random((f, v)).astype(np.float32)
    if dup == "none":
        ids = np.stack([rng.permutation(v)[:b // 2] for _ in range(f)], 1)
    elif dup == "some":
        ids = rng.integers(0, 4, (b, f))
    else:
        ids = np.zeros((b, f), np.int64)
    ids = ids.astype(np.int32)
    g = rng.standard_normal((ids.shape[0], f, d)).astype(np.float32)
    t_tab, t_acc = torch.from_numpy(tables.copy()), torch.from_numpy(acc.copy())
    out_tab, out_acc = rm.rowwise_adagrad_update(
        t_tab, t_acc, torch.from_numpy(ids), torch.from_numpy(g), lr=0.05)
    assert out_tab is t_tab and out_acc is t_acc
    j_tab, j_acc = jrm.rowwise_adagrad_update(
        jnp.asarray(tables), jnp.asarray(acc), jnp.asarray(ids),
        jnp.asarray(g), lr=0.05)
    _close(t_acc, j_acc)
    _close(t_tab, j_tab)
    untouched = np.ones((f, v), bool)
    untouched[np.arange(f)[None, :], ids] = False
    np.testing.assert_array_equal(t_tab.numpy()[untouched], tables[untouched])


@pytest.mark.parametrize("chunk", [3, rm.RETRIEVE_CHUNK])
def test_dlrm_retrieve_matches_forward_with_candidate(monkeypatch, chunk):
    """The reference's own identity (``tests/test_arch_smoke.py:145-162``):
    retrieval with field 0 swapped equals the forward with the candidate
    substituted; and equals the reference's retrieval, whatever the
    chunk of candidates."""
    monkeypatch.setattr(rm, "RETRIEVE_CHUNK", chunk)
    cfg, jcfg, jp, p = _setup("dlrm_rm2")
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((1, cfg.n_dense)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab, (1, cfg.n_sparse)).astype(np.int32)
    cand = rng.integers(0, cfg.vocab, 7).astype(np.int32)
    fast = rm.dlrm_retrieve(cfg, p, torch.from_numpy(dense),
                            torch.from_numpy(ids), torch.from_numpy(cand))
    slow = []
    for c in cand:
        ids2 = ids.copy()
        ids2[0, 0] = c
        slow.append(float(rm.dlrm_forward(cfg, p, torch.from_numpy(dense),
                                          torch.from_numpy(ids2))[0]))
    np.testing.assert_allclose(fast.numpy(), np.array(slow), rtol=1e-4,
                               atol=1e-5)
    _close(fast, jrm.dlrm_retrieve(jcfg, jp, jnp.asarray(dense),
                                   jnp.asarray(ids), jnp.asarray(cand)))


def test_bert4rec_functions_match_reference():
    """``_ln``, the full-vocab cloze loss with its gradients, serve and
    retrieve, with padded keys in the sequences."""
    cfg, jcfg, jp, p = _setup("bert4rec")
    seq, smask, mpos, labels, negs = _feats("bert4rec", cfg, seed=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, cfg.embed_dim)).astype(np.float32)
    w = rng.standard_normal(cfg.embed_dim).astype(np.float32)
    _close(rm._ln(torch.from_numpy(x), torch.from_numpy(w)),
           jrm._ln(jnp.asarray(x), jnp.asarray(w)))
    lab = rng.integers(0, cfg.n_items, seq.shape).astype(np.int32)
    lmask = (rng.random(seq.shape) < 0.3).astype(np.float32)
    t = [torch.from_numpy(a) for a in (seq, smask, lab, lmask)]
    j = [jnp.asarray(a) for a in (seq, smask, lab, lmask)]
    loss, grads = value_and_grad(lambda q: rm.bert4rec_loss(cfg, q, *t), p)
    jloss, jgrads = jax.value_and_grad(
        lambda q: jrm.bert4rec_loss(jcfg, q, *j))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _assert_grads(grads, jgrads)
    slate = rng.integers(0, cfg.n_items, (B, 5)).astype(np.int32)
    u, sc = rm.bert4rec_serve(cfg, p, t[0], t[1], torch.from_numpy(slate))
    ju, jsc = jrm.bert4rec_serve(jcfg, jp, j[0], j[1], jnp.asarray(slate))
    _close(u, ju)
    _close(sc, jsc)
    cand = np.arange(cfg.n_items, dtype=np.int32)
    _close(rm.bert4rec_retrieve(cfg, p, t[0], t[1], torch.from_numpy(cand)),
           jrm.bert4rec_retrieve(jcfg, jp, j[0], j[1], jnp.asarray(cand)))


def test_dlrm_rowwise_step_matches_reference_production_step():
    """``launch/train.py::dlrm_rowwise_step`` against the reference's
    production step (``launch/cells.py:510-527``, composed here from the
    reference's functions as that step composes them): 3 steps with
    duplicate ids, Adam 1e-4 on the MLPs; losses, tables, the row
    accumulator and the MLPs."""
    from repro.optim import adam as jadam
    from repro_torch.launch.train import dlrm_rowwise_step
    from repro_torch.optim import adam
    cfg, jcfg, jp, p = _setup("dlrm_rm2")
    jopt, opt = jadam(1e-4), adam(1e-4)

    def jstep(params, opt_state, dense, ids, labels):
        emb = jrm.lookup_fields(params["tables"], ids)

        def loss_fn(emb, mlps):
            p2 = dict(params, **mlps)
            return jrm.bce_loss(jrm.dlrm_forward_from_emb(jcfg, p2, dense,
                                                          emb), labels)

        mlps = {k: params[k] for k in ("bot", "top")}
        loss, (g_emb, g_mlp) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            emb, mlps)
        tables, acc = jrm.rowwise_adagrad_update(params["tables"],
                                                 opt_state["acc"], ids, g_emb)
        new_mlps, mlp_state = jopt.update(g_mlp, opt_state["mlp"], mlps)
        return dict(params, tables=tables, **new_mlps), \
            {"acc": acc, "mlp": mlp_state}, loss

    acc = np.zeros((cfg.n_sparse, cfg.vocab), np.float32)
    jmlps = {k: jp[k] for k in ("bot", "top")}
    jstate = (jp, {"acc": jnp.asarray(acc), "mlp": jopt.init(jmlps)})
    state = (p, {"acc": torch.from_numpy(acc.copy()),
                 "mlp": opt.init({k: p[k] for k in ("bot", "top")})})
    step = dlrm_rowwise_step(cfg, opt)
    for seed in range(3):
        dense, ids, labels = _feats("dlrm_rm2", cfg, seed=10 + seed)
        *jstate, jloss = jstep(*jstate, jnp.asarray(dense), jnp.asarray(ids),
                               jnp.asarray(labels))
        *state, loss = step(*state, torch.from_numpy(dense),
                            torch.from_numpy(ids), torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert state[0]["tables"] is p["tables"]            # updated in place
    _close(state[1]["acc"], jstate[1]["acc"])
    _close(state[0]["tables"], jstate[0]["tables"])
    for key in ("bot", "top"):
        for (path, t), (_, a) in zip(tree_paths(state[0][key]),
                                     _jpaths(jstate[0][key])):
            assert _rel(t.numpy(), a) <= GRAD_RTOL, (key, path)

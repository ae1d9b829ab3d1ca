"""The port's GCN (``repro_torch.models.gcn``) against ``repro.models.gcn``
at the gcn-cora SMOKE config: the full-graph forward, the sampled-block
forward on blocks from the port's sampler, the batched (molecule) forward
and the loss with its gradients, all from the reference's initial params
carried across through numpy.

Tolerances: forwards and losses rtol 1e-5 (atol 1e-6: the same fp32 sums
in another order); gradients within 1e-4 relative in the norm per leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import graph as jgraph
from repro.data import sampler as jsampler
from repro.models import gcn as jgcn
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core import graph
from repro_torch.data import sampler
from repro_torch.core.train_step import value_and_grad
from repro_torch.models import gcn
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


def _cfg():
    return configs.get("gcn_cora").SMOKE, jconfigs.get("gcn_cora").SMOKE


def _params(jcfg, seed=0):
    jp = jgcn.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _graph(cfg, n=60, e=300, e_pad=320, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    x = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    lmask = (rng.random(n) < 0.7).astype(np.float32)
    return (graph.from_numpy(src, dst, n, e_pad, device="cpu"),
            jgraph.from_numpy(src, dst, n, e_pad), x, labels, lmask)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_grads(grads, jgrads):
    for l, (g, jg) in enumerate(zip(grads["layers"], jgrads["layers"])):
        for name in ("w", "b"):
            assert _rel(g[name].numpy(), jg[name]) <= GRAD_RTOL, (l, name)


def test_config_and_init_match_reference():
    cfg, jcfg = _cfg()
    for variant in ("FULL", "SMOKE"):
        assert dataclasses.asdict(getattr(configs.get("gcn_cora"), variant)) \
            == dataclasses.asdict(getattr(jconfigs.get("gcn_cora"), variant))
    mod, jmod = configs.get("gcn-cora"), jconfigs.get("gcn-cora")
    assert (mod.FAMILY, mod.OPTIMIZER) == (jmod.FAMILY, jmod.OPTIMIZER)
    jp, _ = _params(jcfg)
    p = gcn.init_params(cfg, 0, device="cpu")
    assert len(p["layers"]) == len(jp["layers"])
    for l, jl in zip(p["layers"], jp["layers"]):
        for name in ("w", "b"):
            assert tuple(l[name].shape) == jl[name].shape
        assert not l["b"].any()
        std = float(np.sqrt(2.0 / jl["w"].shape[0]))
        assert 0.5 * std < float(l["w"].std()) < 1.5 * std


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(seed):
    cfg, jcfg = _cfg()
    g, jg, x, _, _ = _graph(cfg, seed=seed)
    jp, p = _params(jcfg, seed)
    got = gcn.forward(cfg, p, g, torch.from_numpy(x))
    want = jgcn.forward(jcfg, jp, jg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_reference(seed):
    cfg, jcfg = _cfg()
    g, jg, x, labels, lmask = _graph(cfg, seed=seed)
    jp, p = _params(jcfg, seed)
    loss, grads = value_and_grad(
        lambda q: gcn.loss_fn(cfg, q, g, torch.from_numpy(x),
                              torch.from_numpy(labels),
                              torch.from_numpy(lmask)), p)
    jloss, jgrads = jax.value_and_grad(
        lambda q: jgcn.loss_fn(jcfg, q, jg, jnp.asarray(x),
                               jnp.asarray(labels), jnp.asarray(lmask)))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _assert_grads(grads, jgrads)


def test_forward_blocks_matches_reference():
    cfg, jcfg = _cfg()
    rng = np.random.default_rng(5)
    n, e = 80, 500
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    seeds = rng.choice(n, 12, replace=False)
    blocks = sampler.sample_blocks(sampler.build_csr(src, dst, n), seeds,
                                   [4, 3], np.random.default_rng(1))
    jblocks = jsampler.sample_blocks(jsampler.build_csr(src, dst, n), seeds,
                                     [4, 3], np.random.default_rng(1))
    for b, jb in zip(blocks, jblocks):           # the port's blocks are the
        for f in ("edge_src", "edge_dst", "edge_mask"):   # reference's
            np.testing.assert_array_equal(getattr(b, f), getattr(jb, f))
    x = rng.standard_normal((blocks[0].n_src, cfg.d_feat)).astype(np.float32)
    jp, p = _params(jcfg)
    tb = [{"edge_src": torch.from_numpy(b.edge_src),
           "edge_dst": torch.from_numpy(b.edge_dst),
           "edge_mask": torch.from_numpy(b.edge_mask), "n_dst": b.n_dst}
          for b in blocks]
    jb = [{"edge_src": jnp.asarray(b.edge_src),
           "edge_dst": jnp.asarray(b.edge_dst),
           "edge_mask": jnp.asarray(b.edge_mask), "n_dst": b.n_dst}
          for b in blocks]
    got = gcn.forward_blocks(cfg, p, tb, torch.from_numpy(x))
    want = jgcn.forward_blocks(jcfg, jp, jb, jnp.asarray(x))
    assert got.shape == (blocks[-1].n_dst, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    labels = rng.integers(0, cfg.n_classes, blocks[-1].n_dst)

    _, grads = value_and_grad(
        lambda q: -torch.log_softmax(gcn.forward_blocks(
            cfg, q, tb, torch.from_numpy(x)), -1)[
                torch.arange(len(labels)), torch.from_numpy(labels)].mean(),
        p)
    jgrads = jax.grad(
        lambda q: -jnp.mean(jax.nn.log_softmax(jgcn.forward_blocks(
            jcfg, q, jb, jnp.asarray(x)), -1)[
                jnp.arange(len(labels)), jnp.asarray(labels)]))(jp)
    _assert_grads(grads, jgrads)


@pytest.mark.parametrize("n_graphs,n_per,e_per", [(4, 6, 10), (3, 30, 64)])
def test_forward_batched_matches_reference(n_graphs, n_per, e_per):
    """The molecule shape: node-batched small graphs with padded edges."""
    cfg, jcfg = _cfg()
    rng = np.random.default_rng(n_graphs)
    src, dst = [], []
    for gi in range(n_graphs):
        src.append(gi * n_per + rng.integers(0, n_per, e_per))
        dst.append(gi * n_per + rng.integers(0, n_per, e_per))
    e = n_graphs * e_per
    src = np.concatenate(src + [np.zeros(5, np.int64)]).astype(np.int32)
    dst = np.concatenate(dst + [np.zeros(5, np.int64)]).astype(np.int32)
    mask = np.arange(e + 5) < e
    n = n_graphs * n_per
    x = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    gid = np.repeat(np.arange(n_graphs), n_per).astype(np.int32)
    jp, p = _params(jcfg)
    targs = [torch.from_numpy(a) for a in (src, dst, mask, x, gid)]
    jargs = [jnp.asarray(a) for a in (src, dst, mask, x, gid)]
    got = gcn.forward_batched(cfg, p, *targs, n_graphs)
    want = jgcn.forward_batched(jcfg, jp, *jargs, n_graphs)
    assert got.shape == (n_graphs, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    _, grads = value_and_grad(
        lambda q: gcn.forward_batched(cfg, q, *targs, n_graphs).square().sum(),
        p)
    jgrads = jax.grad(lambda q: jnp.sum(jgcn.forward_batched(
        jcfg, q, *jargs, n_graphs) ** 2))(jp)
    _assert_grads(grads, jgrads)

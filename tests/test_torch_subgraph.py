"""The port's subgraph-training baseline on the CPU against the reference:
the host sampler byte for byte under one ``np.random.Generator`` seed
(CSR build, k-hop blocks, redundancy), the Table 5 memory model, and
``SubgraphTrainer.step``'s gradients and expanded-vertex counts."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sampler as jsampler
from repro.data import synth as jsynth
from repro.dist import subgraph as jsubgraph
from repro_torch.data import sampler
from repro_torch.dist import subgraph

GRAD_TOL = dict(rtol=1e-5, atol=1e-7)   # fp32 sums in another order


def _directed(seed=0, n_users=80, n_items=50, edges=900):
    """Both edge directions of a bipartite graph, items re-based."""
    data = jsynth.generate_bipartite(n_users, n_items, edges, seed=seed)
    src = np.concatenate([data.user, data.item + data.n_users])
    dst = np.concatenate([data.item + data.n_users, data.user])
    return src, dst, data.n_users + data.n_items, data.n_users


@pytest.mark.parametrize("n_nodes,e", [(50, 300), (70_000, 200_000),
                                       (10, 0)])
def test_build_csr_is_byte_equal(n_nodes, e):
    rng = np.random.default_rng(e)
    src = rng.integers(0, n_nodes, e).astype(np.int32)
    dst = rng.integers(0, n_nodes, e).astype(np.int32)
    got = sampler.build_csr(src, dst, n_nodes)
    want = jsampler.build_csr(src, dst, n_nodes)
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.n_nodes == want.n_nodes
    v = np.arange(min(n_nodes, 20))
    np.testing.assert_array_equal(got.degree(v), want.degree(v))


def _blocks_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize("fanouts", [[3], [4, 2], [10, 10, 10], [None, 3],
                                     [None]])
def test_sample_blocks_are_byte_equal(fanouts):
    src, dst, n, n_users = _directed()
    g, jg = sampler.build_csr(src, dst, n), jsampler.build_csr(src, dst, n)
    seeds = np.random.default_rng(2).integers(0, n_users, 24).astype(np.int32)
    got = sampler.sample_blocks(g, seeds, fanouts, np.random.default_rng(7),
                                pad_multiple=16)
    want = jsampler.sample_blocks(jg, seeds, fanouts,
                                  np.random.default_rng(7), pad_multiple=16)
    _blocks_equal(got, want)
    # and again from one generator: the random stream advances alike
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):
        _blocks_equal(sampler.sample_blocks(g, seeds, fanouts, rng_a),
                      jsampler.sample_blocks(jg, seeds, fanouts, rng_b))


def test_subgraph_redundancy_is_equal():
    src, dst, n, n_users = _directed(seed=3)
    g, jg = sampler.build_csr(src, dst, n), jsampler.build_csr(src, dst, n)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    got, want = [], []
    for b in range(4):
        seeds = np.arange(b * 10, b * 10 + 16, dtype=np.int32) % n_users
        got.append(sampler.sample_blocks(g, seeds, [5, 5], rng))
        want.append(jsampler.sample_blocks(jg, seeds, [5, 5], jrng))
    r = sampler.subgraph_redundancy(got)
    assert r == jsampler.subgraph_redundancy(want)
    assert r > 1.0
    assert sampler.subgraph_redundancy([]) == jsampler.subgraph_redundancy([])


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("fanout", [10, None])
def test_max_subgraph_batch_is_equal(layers, fanout):
    for mem in (1e6, 8e9, 80e9):
        for deg in (3.5, 37.0):
            kw = dict(n_nodes_est_per_seed=1.0, embed_dim=128,
                      n_layers=layers, mem_bytes=mem, fanout=fanout,
                      avg_degree=deg)
            assert subgraph.max_subgraph_batch(**kw) \
                == jsubgraph.max_subgraph_batch(**kw)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_subgraph_step_matches_reference(layers):
    """Two steps of a 2-worker trainer (fanout 10, loss mean(e²), as the
    paper's example runs it): the same blocks, so the same expanded
    vertices, redundancy and gradients w.r.t. the embedding table."""
    src, dst, n, n_users = _directed(seed=4)
    x = np.random.default_rng(5).standard_normal((n, 16)).astype(np.float32)
    tr = subgraph.SubgraphTrainer(src, dst, n, n_layers=layers, fanout=10,
                                  n_workers=2)
    jtr = jsubgraph.SubgraphTrainer(src, dst, n, n_layers=layers, fanout=10,
                                    n_workers=2)
    seed_rng = np.random.default_rng(6)
    for record in (False, True):
        seeds = seed_rng.integers(0, n_users, 32).astype(np.int32)
        grads, st = tr.step(seeds, torch.from_numpy(x),
                            lambda e, s: torch.mean(e ** 2), record=record)
        jgrads, jst = jtr.step(seeds, jnp.asarray(x),
                               lambda e, s: jnp.mean(e ** 2), record=record)
        assert st.expanded_vertices == jst.expanded_vertices > len(
            np.unique(seeds))
        assert st.sample_s > 0 and st.forward_s > 0 and st.backward_s > 0
        assert grads.shape == x.shape
        np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads),
                                   **GRAD_TOL)
        assert (grads.numpy() != 0).any()
    assert tr.redundancy() == jtr.redundancy()

"""The port's graph and LightGCN forward against the reference, from the
same initial params (the reference's init, carried over by
``params_from_jax``), on the lightgcn-smoke and quickstart shapes."""
import jax
import numpy as np
import pytest
import torch

from repro.data import synth as jsynth
from repro.pipeline.registry import get_model as j_get_model
from repro.pipeline.sparse import BipartiteCSR as JBipartiteCSR
from repro_torch.convert import params_from_jax
from repro_torch.core.lightgcn import init_params
from repro_torch.device import resolve_device
from repro_torch.pipeline import BipartiteCSR, get_model

# (n_users, n_items, edges, embed_dim, n_layers): lightgcn-smoke is
# src/repro/configs/lightgcn.py SMOKE; quickstart is the api preset
SHAPES = {
    "lightgcn-smoke": lambda: (jsynth.generate_bipartite(64, 48, 512, seed=0),
                               16, 2),
    "quickstart": lambda: (jsynth.scaled("movielens-10m", 8000, seed=0), 32, 2),
}


def _both(name):
    data, d, layers = SHAPES[name]()
    train, _ = jsynth.train_test_split(data, 0.1, seed=0)
    jg = JBipartiteCSR(train.user, train.item, train.n_users, train.n_items,
                       impl="xla")
    tg = BipartiteCSR(train.user, train.item, train.n_users, train.n_items,
                      device="cpu")
    params = j_get_model("lightgcn").init(jax.random.PRNGKey(0),
                                          train.n_users, train.n_items, d,
                                          layers)
    np_params = {k: np.array(v) for k, v in params.items()}
    return jg, tg, params, np_params, layers


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_lightgcn_forward_matches_reference(name):
    jg, tg, params, np_params, layers = _both(name)
    ju, ji = j_get_model("lightgcn").forward(params, jg, layers)
    with torch.inference_mode():
        tu, ti = get_model("lightgcn").forward(
            params_from_jax(np_params, device="cpu"), tg, layers)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_aggregations_and_sym_propagate_match_reference(name):
    jg, tg, params, np_params, _ = _both(name)
    xu, xi = np_params["user_embed"], np_params["item_embed"]
    tu, ti = torch.from_numpy(xu), torch.from_numpy(xi)
    np.testing.assert_allclose(tg.agg_u2i(tu).numpy(),
                               np.asarray(jg.agg_u2i(xu)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.agg_i2u(ti).numpy(),
                               np.asarray(jg.agg_i2u(xi)), rtol=1e-5, atol=1e-6)
    hu, hi = tg.sym_propagate(tu, ti)
    jhu, jhi = jg.sym_propagate(xu, xi)
    np.testing.assert_allclose(hu.numpy(), np.asarray(jhu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=1e-5, atol=1e-6)
    for a, b in zip(tg.seen_csr(), jg.seen_csr()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tg.ui_indptr.dtype == torch.int64 and tg.ui_src.dtype == torch.int32


def test_edge_mask_drops_edges_like_reference():
    rng = np.random.default_rng(3)
    user = rng.integers(0, 10, 60).astype(np.int32)
    item = rng.integers(0, 8, 60).astype(np.int32)
    mask = rng.random(60) > 0.4
    jg = JBipartiteCSR(user, item, 10, 8, edge_mask=mask, impl="xla")
    tg = BipartiteCSR(user, item, 10, 8, edge_mask=mask, device="cpu")
    assert tg.n_edges == jg.n_edges
    np.testing.assert_array_equal(tg.ui_indptr.numpy(), np.asarray(jg.ui_indptr))
    np.testing.assert_array_equal(tg.rsqrt_du.numpy(), np.asarray(jg.rsqrt_du))


def test_init_params_seeded_shapes_and_scale():
    a = init_params(0, 300, 200, 64, device="cpu")
    b = get_model("lightgcn").init(0, 300, 200, 64, 3, device="cpu")
    c = init_params(1, 300, 200, 64, device="cpu")
    assert a["user_embed"].shape == (300, 64) and a["item_embed"].shape == (200, 64)
    assert a["user_embed"].dtype == torch.float32
    for k in a:
        assert torch.equal(a[k], b[k])                 # same seed, same draw
        assert not torch.equal(a[k], c[k])
    std = float(torch.cat([a["user_embed"], a["item_embed"]]).std())
    assert abs(std - 1 / 8) < 0.01                      # N(0, 1/embed_dim)


def test_params_from_jax_carries_values():
    params = j_get_model("lightgcn").init(jax.random.PRNGKey(3), 7, 5, 4, 2)
    got = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                          device="cpu")
    for k, v in params.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    with pytest.raises(TypeError, match="not a float array"):
        params_from_jax({"ids": np.arange(3)}, device="cpu")


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BipartiteCSR(np.zeros(1, np.int32), np.zeros(1, np.int32), 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, 2, 2, 4)
    assert resolve_device("cpu") == torch.device("cpu")

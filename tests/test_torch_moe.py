"""The port's sort-based MoE (``repro_torch.models.moe``) against
``repro.models.moe`` on the mixtral and kimi SMOKE configs, on a case
with ``capacity_factor=0.25`` so that pairs drop, and on routers whose
logits tie (a zero router: every logit 0; duplicated expert columns).

The reference's routing is not a function of its own, so the oracle
below (``ref_routing``) runs the reference's lines of ``moe_ffn``
(``src/repro/models/moe.py:45-60``) in JAX on the same inputs.  Top-k ids,
the sort order, capacity positions and the drop set are held bit for bit;
outputs and gradients within float32 tolerance (rtol 1e-5, atol 1e-6;
gradients 1e-4 relative in the norm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
CASES = {"mixtral": ("mixtral_8x7b", {}),
         "kimi": ("kimi_k2_1t_a32b", {}),
         "mixtral_drops": ("mixtral_8x7b", {"capacity_factor": 0.25}),
         "kimi_drops": ("kimi_k2_1t_a32b", {"capacity_factor": 0.25})}
ROUTERS = ["random", "zero", "tied_columns"]
MOE_LEAVES = ("router", "w_up", "w_gate", "w_down", "ws_up", "ws_down")


def setup(case, router, seed=0):
    arch, over = CASES[case]
    cfg = dataclasses.replace(jconfigs.get(arch).SMOKE, **over)
    params = jt.init_params(cfg, jax.random.PRNGKey(seed))
    w = {k: np.array(v[0]) for k, v in params["layers"].items()
         if k in MOE_LEAVES}
    if router == "zero":
        w["router"] = np.zeros_like(w["router"])
    elif router == "tied_columns":
        w["router"][:, 1::2] = w["router"][:, 0::2]
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return cfg, w, x


def ref_routing(cfg, xt, router):
    """The reference's routing lines, on [T, D] inputs."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gate_logits = xt.astype(jnp.float32) @ router
    topw, topi = jax.lax.top_k(gate_logits, k)
    topw = jax.nn.softmax(topw, axis=-1).astype(xt.dtype)
    cap = int((t * k) / e * cfg.capacity_factor) + 1
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    pos = jnp.arange(t * k) - first
    pos_c = jnp.where(pos < cap, pos, cap)
    return topi, topw, order, pos_c, cap


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("case", list(CASES))
def test_routing_bitwise(case, router):
    cfg, w, x = setup(case, router)
    xt = x.reshape(-1, cfg.d_model)
    topi, topw, order, pos_c, cap = ref_routing(
        cfg, jnp.asarray(xt), jnp.asarray(w["router"]))
    r = moe.dispatch(cfg, torch.from_numpy(xt), torch.from_numpy(w["router"]))
    assert r.cap == cap
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(topi))
    np.testing.assert_array_equal(r.order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(r.pos_c.numpy(), np.asarray(pos_c))
    dropped = r.pos_c.numpy() == cap
    np.testing.assert_array_equal(dropped, np.asarray(pos_c) == cap)
    if "drops" in case:
        assert dropped.any()
    np.testing.assert_allclose(r.topw.numpy(), np.asarray(topw), rtol=RTOL,
                               atol=ATOL)


def test_top_k_ties_to_the_lower_id():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0],
                           [0.0, -0.0, 0.0, 0.0, 2.0]])
    vals, ids = moe.top_k(logits, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case, router):
    cfg, w, x = setup(case, router)
    want = jmoe.moe_ffn(cfg, jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in w.items()})
    got = moe.moe_ffn(cfg, torch.from_numpy(x), params_from_jax(w, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["mixtral", "kimi_drops"])
def test_moe_ffn_grads_match_jax(case):
    cfg, w, x = setup(case, "random")
    ct = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def f(xx, ww):
        return jnp.sum(jmoe.moe_ffn(cfg, xx, ww) * ct)

    gx, gw = jax.grad(f, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {k: v.requires_grad_(True)
          for k, v in params_from_jax(w, "cpu").items()}
    (moe.moe_ffn(cfg, tx, tw) * torch.from_numpy(ct)).sum().backward()
    for got, want in [(tx.grad, gx)] + [(tw[k].grad, gw[k]) for k in w]:
        want = np.asarray(want)
        err = np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want),
                                                       1e-30)
        assert err <= 1e-4


@pytest.mark.parametrize("case", ["mixtral", "kimi"])
def test_load_balance_loss_matches_reference(case):
    cfg, w, x = setup(case, "random")
    xt = x.reshape(-1, cfg.d_model)
    logits = xt @ w["router"]
    topi = np.array(jax.lax.top_k(jnp.asarray(logits), cfg.top_k)[1])
    want = jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(topi),
                                  cfg.n_experts)
    got = moe.load_balance_loss(torch.from_numpy(logits),
                                torch.from_numpy(topi).long(), cfg.n_experts)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)

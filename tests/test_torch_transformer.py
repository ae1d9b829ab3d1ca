"""The port's LM backbone (``repro_torch.models.transformer``) and the five
LM configs against ``repro.models.transformer`` and ``repro.configs``:
every SMOKE config from the reference's init carried across through
``convert.params_from_jax``, through ``forward``, ``lm_loss``, ``prefill``
and ``decode_step`` (with the reference's clamp of the cache write), and
20-step ``train_step`` trajectories with each config's optimizer at 1 and
2 microbatches; the configs' fields and parameter counts; the init's tree;
and a bfloat16 config, whose step-1 Adam update turns the params float32
as the reference's does (C2).

Tolerances: logits, caches and losses rtol 1e-5 (atol 2e-6);
trajectories' losses rtol 1e-5 at every step and the final params within
1e-3 relative in the norm per leaf (Adam divides by sqrt(v), which
amplifies the last bits of near-zero gradients); bfloat16 logits within
5e-2 absolute.  The optimizers run at lr 1e-3: adafactor's updates are
sign-like, and at its default lr 1e-2 the reference's own jitted and eager
trajectories part within 20 steps on these configs.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.optim import optimizers as jopt
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.optim import optimizers as topt
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 2e-6
LM_ARCHS = ["nemotron_4_340b", "gemma2_2b", "granite_3_8b", "mixtral_8x7b",
            "kimi_k2_1t_a32b"]
B, S, SC = 2, 20, 24       # batch, prompt length, cache capacity
LR = 1e-3


def ref_state(arch, seed=0):
    cfg = jconfigs.get(arch).SMOKE
    jp = jt.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, configs.get(arch).SMOKE, jp, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def flat(tree_j):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree_j)}


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_reference(arch):
    mod, jmod = configs.get(arch), jconfigs.get(arch)
    for attr in ("FAMILY", "OPTIMIZER", "SHAPES", "SKIP"):
        assert getattr(mod, attr) == getattr(jmod, attr)
    for variant in ("FULL", "SMOKE"):
        cfg, jcfg = getattr(mod, variant), getattr(jmod, variant)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.head_dim == jcfg.head_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_tree_matches_reference(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.get(arch).SMOKE, dtype=dtype)
    cfg = dataclasses.replace(configs.get(arch).SMOKE, dtype=dtype)
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                lambda: jt.init_params(jcfg, jax.random.PRNGKey(0))))}
    got = dict(topt.tree_paths(tt.init_params(cfg, 0, device="cpu")))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    again = dict(topt.tree_paths(tt.init_params(cfg, 0, device="cpu")))
    assert all(torch.equal(again[k], v) for k, v in got.items())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, cfg, jp, tp = ref_state(arch)
    toks, labels = tokens(jcfg, 1, (B, S)), tokens(jcfg, 2, (B, S))
    want = jt.forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        got = tt.forward(cfg, tp, torch.from_numpy(toks))
    assert got.shape == (B, S, jcfg.vocab) and got.dtype == torch.float32
    close(got, want)
    want_l = jt.lm_loss(jcfg, jp, jnp.asarray(toks), jnp.asarray(labels))
    got_l = tt.lm_loss(cfg, tp, torch.from_numpy(toks),
                       torch.from_numpy(labels))
    close(got_l, want_l)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """prefill's logits and cache; then three decode steps from a cache
    of capacity SC holding the prompt, logits and caches each step."""
    jcfg, cfg, jp, tp = ref_state(arch)
    toks = tokens(jcfg, 3, (B, S))
    jl, jc = jt.prefill(jcfg, jp, jnp.asarray(toks))
    tl, tc = tt.prefill(cfg, tp, torch.from_numpy(toks))
    close(tl, jl)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    cache = jt.init_kv_cache(jcfg, B, SC)
    cache = {n: cache[n].at[:, :, :, :S].set(jc[n]) for n in ("k", "v")}
    tcache = {n: torch.from_numpy(np.array(cache[n])) for n in ("k", "v")}
    for i, nxt in enumerate(tokens(jcfg, 4, (3, B, 1))):
        jl, cache = jt.decode_step(jcfg, jp, jnp.asarray(nxt), cache,
                                   jnp.int32(S + i))
        tl, tcache = tt.decode_step(cfg, tp, torch.from_numpy(nxt), tcache,
                                    S + i)
        close(tl, jl)
        close(tcache["k"], cache["k"])
        close(tcache["v"], cache["v"])


@pytest.mark.parametrize("arch", ["gemma2_2b", "granite_3_8b"])
def test_decode_clamps_the_cache_write_like_the_reference(arch):
    """A position past the cache: dynamic_update_slice clamps its start to
    the last slot, the mask and rope keep the position given."""
    jcfg, cfg, jp, tp = ref_state(arch)
    cache = jt.init_kv_cache(jcfg, B, 8)
    tcache = tt.init_kv_cache(cfg, B, 8, device="cpu")
    for pos, nxt in zip((0, 5, 11), tokens(jcfg, 5, (3, B, 1))):
        jl, cache = jt.decode_step(jcfg, jp, jnp.asarray(nxt), cache,
                                   jnp.int32(pos))
        tl, tcache = tt.decode_step(cfg, tp, torch.from_numpy(nxt), tcache,
                                    pos)
        close(tl, jl)
        close(tcache["k"], cache["k"])


def _opts(arch):
    if jconfigs.get(arch).OPTIMIZER == "adafactor":
        return jopt.adafactor(LR), topt.adafactor(LR)
    return jopt.adam(LR), topt.adam(LR)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_trajectory_matches_reference(arch, n_micro):
    jcfg, cfg, jp, tp = ref_state(arch)
    jo, to = _opts(arch)
    js, ts = jo.init(jp), to.init(tp)
    step = jax.jit(partial(jt.train_step, jcfg, jo, n_microbatches=n_micro))
    for i in range(20):
        toks, labels = tokens(jcfg, 10 + i, (4, 16)), tokens(jcfg, 50 + i,
                                                             (4, 16))
        jp, js, jl = step(jp, js, jnp.asarray(toks), jnp.asarray(labels))
        tp, ts, tl = tt.train_step(cfg, to, tp, ts, torch.from_numpy(toks),
                                   torch.from_numpy(labels),
                                   n_microbatches=n_micro)
        assert np.isfinite(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    want = flat(jp)
    for k, v in topt.tree_paths(tp):
        err = np.linalg.norm(v.numpy() - want[k]) / np.linalg.norm(want[k])
        assert err <= 1e-3, (k, err)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_bfloat16_train_step_promotes_like_the_reference(n_micro):
    """gemma2 SMOKE in bfloat16 from the reference's bf16 init: the loss
    within bf16 tolerance, and after one Adam step every param leaf
    float32 and the moments in the reference's dtypes (C2)."""
    arch = "gemma2_2b"
    jcfg = dataclasses.replace(jconfigs.get(arch).SMOKE, dtype="bfloat16")
    cfg = dataclasses.replace(configs.get(arch).SMOKE, dtype="bfloat16")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["router" if cfg.is_moe else "wq"].dtype \
        == torch.bfloat16
    toks = tokens(jcfg, 6, (4, 16))
    with torch.no_grad():
        close(tt.forward(cfg, tp, torch.from_numpy(toks)),
              jt.forward(jcfg, jp, jnp.asarray(toks)), rtol=0, atol=5e-2)
    jo, to = jopt.adam(LR), topt.adam(LR)
    jp2, js2, jl = jt.train_step(jcfg, jo, jp, jo.init(jp),
                                 jnp.asarray(toks), jnp.asarray(toks),
                                 n_microbatches=n_micro)
    tp2, ts2, tl = tt.train_step(cfg, to, tp, to.init(tp),
                                 torch.from_numpy(toks),
                                 torch.from_numpy(toks),
                                 n_microbatches=n_micro)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    for jtree, ttree in ((jp2, tp2), (js2["m"], ts2["m"]),
                         (js2["v"], ts2["v"])):
        want = flat(jtree)
        got = dict(topt.tree_paths(ttree))
        assert {k: str(v.dtype).split(".")[-1] for k, v in got.items()} \
            == {k: str(v.dtype) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for _, v in topt.tree_paths(tp2))

"""The port's training slice on the CPU against the reference: model
forwards (NGCF fused and composed, GCN, LightGCN) from the same params,
the BPR loss, the optimizers, the large-batch schedule, the loader, the
engine's accumulation and resume arithmetic, and 20-step training
trajectories of ``Pipeline.step_fn`` from the same initial state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpr as jbpr
from repro.core.large_batch import LargeBatchSchedule as JSchedule
from repro.data import synth as jsynth
from repro.data.loader import EdgeLoader as JEdgeLoader
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jbuild_pipeline
from repro.pipeline.plan import derive_microbatch as jderive_microbatch
from repro.pipeline.registry import get_model as jget_model
from repro.pipeline.sparse import BipartiteCSR as JBipartiteCSR
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import bpr
from repro_torch.core.large_batch import LargeBatchSchedule
from repro_torch.data import synth
from repro_torch.data.loader import EdgeLoader
from repro_torch.optim import adam, sgd
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.pipeline import (BipartiteCSR, PipelineConfig, build_pipeline,
                                  get_model)
from repro_torch.pipeline.plan import derive_microbatch
from torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy


def _flat(tree, prefix=""):
    """{path: numpy array} over nested dicts/lists (dict keys sorted, so
    both packages' trees line up)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}.{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees_close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _smoke_data(edges=512):
    """ngcf-smoke / lightgcn-smoke shapes (64 users x 48 items); the
    port's generator gives the reference's bytes."""
    data = synth.generate_bipartite(64, 48, edges, seed=0)
    train, test = synth.train_test_split(data, 0.1, seed=0)
    jtrain, _ = jsynth.train_test_split(
        jsynth.generate_bipartite(64, 48, edges, seed=0), 0.1, seed=0)
    np.testing.assert_array_equal(train.user, jtrain.user)
    np.testing.assert_array_equal(train.item, jtrain.item)
    return train, test


def _jax_params(arch, n_users, n_items, d, layers, seed=0):
    params = jget_model(arch).init(jax.random.PRNGKey(seed), n_users,
                                   n_items, d, layers)
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch,hadamard", [("ngcf", "fused"),
                                           ("ngcf", "composed"),
                                           ("gcn", "auto"),
                                           ("lightgcn", "auto")])
def test_model_forward_matches_reference(arch, hadamard):
    train, _ = _smoke_data()
    jg = JBipartiteCSR(train.user, train.item, 64, 48, impl="xla",
                       hadamard=hadamard)
    tg = BipartiteCSR(train.user, train.item, 64, 48, device="cpu",
                      hadamard=hadamard)
    params, np_params = _jax_params(arch, 64, 48, 16, 2)
    ju, ji = jget_model(arch).forward(params, jg, 2)
    with torch.no_grad():
        tu, ti = get_model(arch).forward(params_from_jax(np_params, "cpu"),
                                         tg, 2)
    spec = get_model(arch)
    assert tu.shape == (64, spec.out_dim(16, 2))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    jspec = jget_model(arch)
    assert spec.materializes_messages == jspec.materializes_messages
    assert spec.concat_layers == jspec.concat_layers
    assert spec.messages_materialized(tg) == jspec.messages_materialized(jg)


def test_ngcf_fused_and_composed_give_equal_loss_and_grads():
    train, _ = _smoke_data()
    _, np_params = _jax_params("ngcf", 64, 48, 16, 2)
    users, pos, neg = bpr.sample_bpr_batch(np.random.default_rng(1),
                                           train.user, train.item, 48, 64)
    out = {}
    for route in ("fused", "composed"):
        cfg = PipelineConfig(arch="ngcf", embed_dim=16, microbatch=64,
                             hadamard=route)
        pipe = build_pipeline(cfg, train, device="cpu")
        out[route] = pipe.value_and_grad(params_from_jax(np_params, "cpu"),
                                         users, pos, neg)
    (lf, gf), (lc, gc) = out["fused"], out["composed"]
    np.testing.assert_allclose(float(lf), float(lc), rtol=1e-6)
    # the two routes sum the same products in other orders; gradients
    # here reach |g| ~ 100
    _assert_trees_close(gf, params_to_numpy(gc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["ngcf", "gcn"])
def test_init_params_layout_matches_reference(arch):
    _, np_params = _jax_params(arch, 30, 20, 8, 3)
    a = get_model(arch).init(0, 30, 20, 8, 3, device="cpu")
    b = get_model(arch).init(0, 30, 20, 8, 3, device="cpu")
    c = get_model(arch).init(1, 30, 20, 8, 3, device="cpu")
    fa, fb, fc, fj = _flat(a), _flat(b), _flat(c), _flat(np_params)
    assert sorted(fa) == sorted(fj)
    for k in fj:
        assert fa[k].shape == fj[k].shape and fa[k].dtype == np.float32
        np.testing.assert_array_equal(fa[k], fb[k])        # same seed
        if fj[k].any():
            assert not np.array_equal(fa[k], fc[k])        # other seed
    big = get_model(arch).init(0, 4000, 10, 64, 1, device="cpu")
    assert abs(float(big["user_embed"].std()) - 1 / 8) < 0.005


@pytest.mark.parametrize("arch", ["ngcf", "gcn", "lightgcn"])
def test_params_round_trip_nested(arch):
    _, np_params = _jax_params(arch, 7, 5, 4, 2, seed=3)
    got = params_from_jax(np_params, device="cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))
    back = params_to_numpy(got)
    for k, v in _flat(np_params).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
    with pytest.raises(TypeError, match=r"layers\[0\].w"):
        params_from_jax({"layers": [{"w": np.arange(3)}]}, device="cpu")


# -------------------------------------------------------------- loss / opt
def test_bpr_loss_and_sampling_match_reference():
    rng = np.random.default_rng(0)
    ue = rng.standard_normal((20, 8)).astype(np.float32)
    ie = rng.standard_normal((15, 8)).astype(np.float32)
    train_u = rng.integers(0, 20, 100).astype(np.int32)
    train_i = rng.integers(0, 15, 100).astype(np.int32)
    u, p, n = bpr.sample_bpr_batch(np.random.default_rng(5), train_u, train_i,
                                   15, 33)
    ju, jp, jn = jbpr.sample_bpr_batch(np.random.default_rng(5), train_u,
                                       train_i, 15, 33)
    for a, b in ((u, ju), (p, jp), (n, jn)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tue, tie = T(ue).requires_grad_(True), T(ie).requires_grad_(True)
    loss = bpr.bpr_loss(tue, tie, T(u).long(), T(p).long(), T(n).long(), l2=1e-2)
    gu, gi = torch.autograd.grad(loss, [tue, tie])
    jloss, (jgu, jgi) = jax.value_and_grad(
        lambda a, b: jbpr.bpr_loss(a, b, u, p, n, l2=1e-2), argnums=(0, 1))(
            jnp.asarray(ue), jnp.asarray(ie))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(gu.numpy(), np.asarray(jgu), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gi.numpy(), np.asarray(jgi), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adam", {})])
def test_optimizer_updates_match_reference(name, kw):
    """Five updates over a nested tree (NGCF's lists), the LR passed per
    call as a float32 scalar as the engine does: equal to the ulp."""
    rng = np.random.default_rng(2)
    shapes = {"user_embed": (6, 4), "w1": [(4, 4), (4, 4)]}

    def draw():
        return {"user_embed": rng.standard_normal((6, 4)).astype(np.float32),
                "w1": [rng.standard_normal(s).astype(np.float32)
                       for s in shapes["w1"]]}

    params = draw()
    topt = {"sgd": sgd, "adam": adam}[name](0.05, **kw)
    jopt = {"sgd": jsgd, "adam": jadam}[name](0.05, **kw)
    tp = params_from_jax(params, "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    ts, js = topt.init(tp), jopt.init(jp)
    for step in range(5):
        grads = draw()
        lr = 0.01 * (step + 1)
        tp, ts = topt.update(params_from_jax(grads, "cpu"), ts, tp,
                             lr=torch.tensor(lr, dtype=torch.float32))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                             lr=jnp.float32(lr))
        _assert_trees_close(tp, jp, rtol=2e-7, atol=1e-7)
    if name == "adam":
        assert int(ts["t"]) == int(js["t"]) == 5 and ts["t"].dtype == torch.int32
    assert _flat(params)[".user_embed"].tobytes() != \
        _flat(tp)[".user_embed"].tobytes()


@pytest.mark.parametrize("scaling", ["linear", "sqrt"])
def test_large_batch_schedule_matches_reference(scaling):
    kw = dict(base_lr=0.02, base_batch=64, target_batch=1024,
              warmup_epochs=2, scaling=scaling)
    a, b = LargeBatchSchedule(**kw), JSchedule(**kw)
    for epoch in range(5):
        assert a.batch_for_epoch(epoch) == b.batch_for_epoch(epoch)
        assert a.lr_for_epoch(epoch) == b.lr_for_epoch(epoch)
    assert a.scaled_lr(300) == b.scaled_lr(300)
    assert a.batch_for_epoch(0) == 102 and a.batch_for_epoch(2) == 1024


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("shard_id,num_shards,drop_last", [
    (0, 1, True), (1, 3, True), (0, 1, False)])
def test_edge_loader_batches_byte_equal(shard_id, num_shards, drop_last):
    rng = np.random.default_rng(0)
    user = rng.integers(0, 50, 301).astype(np.int32)
    item = rng.integers(0, 40, 301).astype(np.int32)
    kw = dict(batch=32, seed=7, shard_id=shard_id, num_shards=num_shards,
              drop_last=drop_last)
    a, b = EdgeLoader(user, item, **kw), JEdgeLoader(user, item, **kw)
    assert a.steps_per_epoch() == b.steps_per_epoch()
    for _ in range(3 * a.steps_per_epoch() + 2):       # across epoch rolls
        (au, ai), (bu, bi) = next(a), next(b)
        assert au.tobytes() == bu.tobytes() and ai.tobytes() == bi.tobytes()
        assert a.state_dict() == b.state_dict()
    c = EdgeLoader(user, item, **kw)
    c.load_state_dict(a.state_dict())
    assert [x.tobytes() for x in next(c)] == [x.tobytes() for x in next(a)]


# ------------------------------------------------------------------ engine
def _state(pipe, jstate):
    """The port's state from the reference's params (fresh optimizer
    state, as the reference's own init has)."""
    params = params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                             device="cpu")
    return {"params": params, "opt": pipe.opt.init(params)}


def _cfg_pair(**kw):
    return PipelineConfig(**kw), JPipelineConfig(**kw)


QUICKSTART = dict(arch="lightgcn", embed_dim=32, n_layers=2, optimizer="sgd",
                  base_lr=0.02, base_batch=64, target_batch=1024,
                  microbatch=256, warmup_epochs=2, lr_scaling="linear")


def test_schedule_arithmetic_and_seek_match_reference():
    """Per-epoch accumulation, LR and steps, and ``seek`` against live
    progression through warm-up into accumulation, against the
    reference's engine."""
    train, _ = _smoke_data()
    cfg, jcfg = _cfg_pair(**{**QUICKSTART, "microbatch": 128})
    pipe = build_pipeline(cfg, train, device="cpu")
    jpipe = jbuild_pipeline(jcfg, train)
    for e in range(4):
        assert pipe.plan.microbatches_for_epoch(e) == \
            jpipe.plan.microbatches_for_epoch(e)
        assert pipe.lr_for_epoch(e) == jpipe.lr_for_epoch(e)
        assert pipe.steps_per_epoch(e) == jpipe.steps_per_epoch(e)
    live = build_pipeline(cfg, train, device="cpu")
    seen_k = set()
    for step in range(12):
        k = live.plan.microbatches_for_epoch(live.current_epoch())
        seen_k.add(k)
        live._next_target_batch(k, step)
        live._next_step = step + 1
        pipe.seek(step + 1)
        jpipe.seek(step + 1)
        assert pipe.loader.state == live.loader.state
        assert dataclasses.asdict(pipe.loader.state) == \
            dataclasses.asdict(jpipe.loader.state)
    assert seen_k == {1, 8}                   # warm-up, then accumulation
    pipe.seek(11)
    jpipe.seek(11)
    k = pipe.plan.microbatches_for_epoch(pipe.current_epoch())
    for a, b in zip(pipe._next_target_batch(k, 11),
                    jpipe._next_target_batch(k, 11)):
        assert a.tobytes() == b.tobytes()


def test_derive_microbatch_matches_reference():
    for free, out_dim, target in [(2**30, 48, 4096), (10**6, 512, 150_528),
                                  (1, 32, 64), (2**34, 128, 150_528)]:
        assert derive_microbatch(free, out_dim, target) == \
            jderive_microbatch(free, out_dim, target)


@pytest.mark.parametrize("batch", [128, 100])   # equal chunks + ragged tail
def test_grads_for_batch_matches_full_batch(batch):
    """Size-weighted accumulation of per-microbatch gradients equals the
    gradient of the full-batch mean loss, ragged tail included."""
    train, _ = _smoke_data()
    cfg = PipelineConfig(arch="ngcf", embed_dim=16, target_batch=128,
                         microbatch=32, base_batch=32)
    pipe = build_pipeline(cfg, train, device="cpu")
    params = pipe.init_state()["params"]
    u, i, n = bpr.sample_bpr_batch(np.random.default_rng(0), train.user,
                                   train.item, 48, batch)
    loss, acc = pipe.grads_for_batch(params, u, i, n)
    full_loss, full = pipe.value_and_grad(params, u, i, n)
    np.testing.assert_allclose(loss, float(full_loss), rtol=1e-5)
    # chunked and whole sums in other orders; NGCF's gradients reach ~100
    _assert_trees_close(acc, params_to_numpy(full), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("field,value", [
    ("mesh_shape", (4,)), ("spmm", "ring"), ("impl", "ring"),
    ("ring_steps", 2), ("ring_compression", "int8")])
def test_unported_config_options_raise(field, value):
    """The sharded-execution options in one process, as the reference
    takes them: a 4-shard mesh at world size 1 raises ValueError (the
    port names the world size and torchrun); the one-shard ring
    (``spmm``/``impl='ring'``) builds with the reference's shard plan and
    ``TrainPlan`` lines; ``ring_steps`` and ``ring_compression`` alone
    leave the plan inert, as the reference's ``from_config`` does."""
    train, _ = _smoke_data()
    cfg = dataclasses.replace(PipelineConfig(microbatch=64), **{field: value})
    jcfg = dataclasses.replace(JPipelineConfig(microbatch=64),
                               **{field: value})
    if field == "mesh_shape":
        with pytest.raises(ValueError, match="world size is 1"):
            build_pipeline(cfg, train, device="cpu")
        with pytest.raises(ValueError):
            jbuild_pipeline(jcfg, train)
        return
    pipe = build_pipeline(cfg, train, device="cpu")
    jpipe = jbuild_pipeline(jcfg, train)
    ring = field in ("spmm", "impl")
    assert (pipe.shard is not None) == (jpipe.shard is not None) == ring
    if ring:
        assert pipe.shard.describe() == jpipe.shard.describe() \
            == "mesh=1 axes=data spmm=ring"
        assert pipe.g.spmm == jpipe.g.spmm == "ring"
    assert _masked(pipe.plan.describe()) == _masked(jpipe.plan.describe())


def _masked(text):
    """``describe()`` lines with the kernel route's token masked: the
    port names its own (torch/cuda), the reference pallas/xla."""
    return [" ".join("impl=*" if w.startswith("impl=") else w
                     for w in line.split(" ")) for line in text.splitlines()]


# the options that demote pair with the uniform topology: on the
# reference's default (tpu-hbm-host) its JAX-CPU backend puts a demoted
# leaf in the pinned_host memory kind, where its step refuses the mixed
# memory spaces (memory/executor.py's docstring)
@pytest.mark.parametrize("field,value", [
    ("microbatch", None), ("hbm_budget", 2**14),
    ("memory_topology", "uniform"), ("memory_policy", "all-fast"),
    ("memory_pins", {"item_embed": "host"}),
    ("grad_compression", "int8"), ("embed_store", "int8")])
def test_planner_and_compression_options_build(field, value):
    """Each planner, tier and compression option builds, gives the
    reference's plan (``Plan.to_dict()``, ``describe()`` but for the
    ``impl=`` token, microbatch, offloaded count) and, from the
    reference's init, its first-step loss within rtol 1e-4."""
    train, _ = _smoke_data()
    kw = dict(target_batch=64, base_batch=64, microbatch=64)
    if field in ("hbm_budget", "memory_pins"):
        kw["memory_topology"] = "uniform"
    kw[field] = value
    cfg, jcfg = _cfg_pair(**kw)
    pipe = build_pipeline(cfg, train, device="cpu")
    jpipe = jbuild_pipeline(jcfg, train)
    assert pipe.plan.plan.to_dict() == jpipe.plan.plan.to_dict()
    assert _masked(pipe.plan.describe()) == _masked(jpipe.plan.describe())
    assert pipe.plan.microbatch == jpipe.plan.microbatch
    assert pipe.n_offloaded == jpipe.n_offloaded
    jstate = jpipe.init_state()
    state = _state(pipe, jstate)
    if "comp" in jstate:
        state["comp"] = pipe.compressor.init_state(state["params"], 0)
    state = pipe.apply_plan(state)
    _, loss = pipe.step_fn(state, 0)
    _, jloss = jpipe.step_fn(jstate, 0)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)


# ------------------------------------------------------------ trajectories
TRAJECTORIES = {
    # ngcf-smoke (src/repro/configs/ngcf.py SMOKE, the smoke preset's plan)
    "ngcf-fused-adam": (dict(arch="ngcf", embed_dim=16, n_layers=2,
                             optimizer="adam", target_batch=64, base_batch=64,
                             microbatch=64, warmup_epochs=0,
                             hadamard="fused"), 512),
    "ngcf-composed-adam": (dict(arch="ngcf", embed_dim=16, n_layers=2,
                                optimizer="adam", target_batch=64,
                                base_batch=64, microbatch=64, warmup_epochs=0,
                                hadamard="composed"), 512),
    # the quickstart schedule (warm-up batch, linear LR, SGD) on a graph
    # small enough that 20 steps cross from warm-up into 4x accumulation
    "lightgcn-sgd-quickstart": (QUICKSTART, 1400),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_training_trajectory_matches_reference(name):
    """20 ``step_fn`` steps of the port against 20 of the reference's
    Pipeline from the same initial state (the reference's init, carried
    across as numpy).  Losses agree to rtol 1e-4.  Params: SGD to
    rtol 1e-4 / atol 1e-6.  Adam moves each element by about lr·sign(g)
    per step, so an element whose gradient cancels to ~0 can step the
    other way under another summation order: Adam's params are held to
    atol 1e-5 everywhere except at most 0.5% of elements, each within
    20 steps x 2 x lr of the reference."""
    kw, edges = TRAJECTORIES[name]
    train, _ = _smoke_data(edges)
    cfg, jcfg = _cfg_pair(**kw)
    jpipe = jbuild_pipeline(jcfg, train)
    pipe = build_pipeline(cfg, train, device="cpu")
    jstate = jpipe.init_state()
    state = _state(pipe, jstate)
    accumulated = set()
    for step in range(20):
        accumulated.add(pipe.plan.microbatches_for_epoch(pipe.current_epoch()))
        jstate, jloss = jpipe.step_fn(jstate, step)
        state, loss = pipe.step_fn(state, step)
        np.testing.assert_allclose(loss, jloss, rtol=1e-4, err_msg=f"step {step}")
    if name.startswith("lightgcn"):
        assert accumulated == {1, 4}          # warm-up, then accumulation
    got, want = _flat(state["params"]), _flat(jstate["params"])
    assert sorted(got) == sorted(want)
    lr = cfg.base_lr
    for k in want:
        if kw["optimizer"] == "sgd":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            continue
        diff = np.abs(got[k] - want[k])
        off = diff > 1e-5
        assert off.mean() <= 0.005, (k, int(off.sum()), diff.max())
        assert diff.max() <= 20 * 2 * lr, (k, diff.max())


def test_evaluate_matches_reference():
    """Held-out metrics of the same trained state through both engines'
    ``evaluate``."""
    train, test = _smoke_data()
    cfg, jcfg = _cfg_pair(**TRAJECTORIES["ngcf-fused-adam"][0])
    jpipe = jbuild_pipeline(jcfg, train, holdout=test)
    pipe = build_pipeline(cfg, train, holdout=test, device="cpu")
    jstate = jpipe.init_state()
    for step in range(3):
        jstate, _ = jpipe.step_fn(jstate, step)
    state = _state(pipe, jstate)
    got, want = pipe.evaluate(state), jpipe.evaluate(jstate)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)

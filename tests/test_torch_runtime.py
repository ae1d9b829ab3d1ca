"""The port's checkpoints and fault-tolerant loop on the CPU against the
reference's: the cases of ``tests/test_runtime.py`` (round trip, atomic
commit, async save, structure mismatch, checkpoint-and-resume, straggler
escalation to ``on_relayout``) and ``eval_every``, each run through both
packages on the same numpy inputs; checkpoints written by either package
restore in the other; and ``run_pipeline`` over the port's ``Pipeline``
with the engine hooks the loop calls."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jlatest_step
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.optim import sgd as jsgd
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jbuild_pipeline
from repro.runtime.loop import LoopConfig as JLoopConfig
from repro.runtime.loop import run_pipeline as jrun_pipeline
from repro.runtime.loop import run_training as jrun_training
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import params_from_jax
from repro_torch.data import synth
from repro_torch.optim import sgd
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.runtime.loop import LoopConfig, run_pipeline, run_training

TARGET = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)


def _tree(rng):
    """A tree with every container kind and leaf dtype the states hold."""
    return {"a": rng.standard_normal(10).astype(np.float32),
            "b": [rng.standard_normal((3, 3)).astype(np.float32),
                  np.zeros(2, np.float32)],
            "t": np.int32(7),
            "c": ({"z": np.arange(4, dtype=np.int32)}, ()),
            "n": None}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree))


def _leaves(tree) -> list:
    """numpy leaves in JAX's order (dict keys sorted; None holds none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)]


# -------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_matches_reference_layout(tmp_path):
    tree = _tree(np.random.default_rng(1))
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    save_checkpoint(tdir, 5, _torch_tree(tree))
    jsave(jdir, 5, jax.tree.map(jnp.asarray, tree))
    assert latest_step(tdir) == jlatest_step(jdir) == 5
    files = sorted(os.listdir(os.path.join(tdir, "step_5")))
    assert files == sorted(os.listdir(os.path.join(jdir, "step_5")))
    with open(os.path.join(tdir, "step_5", "manifest.json")) as f:
        got = json.load(f)
    with open(os.path.join(jdir, "step_5", "manifest.json")) as f:
        want = json.load(f)
    assert got == want
    restored, step = restore_checkpoint(tdir, _torch_tree(tree))
    assert step == 5
    assert isinstance(restored["b"], list) and isinstance(restored["c"], tuple)
    assert restored["n"] is None and restored["c"][1] == ()
    for a, b in zip(_leaves(restored), jax.tree.leaves(tree)):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A state tree written by one package restores in the other, bit for
    bit, on the example leaves' dtypes."""
    rng = np.random.default_rng(2)
    params = {"user_embed": rng.standard_normal((6, 4)).astype(np.float32),
              "w1": [rng.standard_normal((4, 4)).astype(np.float32)]}
    state = {"params": params,
             "opt": {"m": jax.tree.map(np.zeros_like, params),
                     "v": jax.tree.map(np.ones_like, params),
                     "t": np.int32(3)}}
    d = str(tmp_path)
    if writer == "reference":
        jsave(d, 9, jax.tree.map(jnp.asarray, state))
        got, step = restore_checkpoint(d, _torch_tree(state))
        assert got["opt"]["t"].dtype == torch.int32
        got = _leaves(got)
    else:
        save_checkpoint(d, 9, _torch_tree(state))
        got, step = jrestore(d, jax.tree.map(jnp.asarray, state))
        got = [np.asarray(x) for x in jax.tree.leaves(got)]
    assert step == 9
    for a, b in zip(got, jax.tree.leaves(state)):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b) \
            and a.tobytes() == np.asarray(b).tobytes()


def test_checkpoint_atomic_commit(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.arange(4)})
    # a torn write (no COMMITTED marker) must be ignored, as the
    # reference ignores it
    os.makedirs(tmp_path / "step_2")
    with open(tmp_path / "step_2" / "manifest.json", "w") as f:
        f.write("{}")
    os.makedirs(tmp_path / "step_3.tmp")
    assert latest_step(str(tmp_path)) == jlatest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "absent"), {"a": torch.arange(4)})


def test_checkpoint_async_copies_before_the_writer(tmp_path):
    """The async save copies the leaves in the caller's thread: an
    in-place write after ``save_checkpoint`` returns does not reach the
    file."""
    a = torch.arange(100, dtype=torch.float32)
    t = save_checkpoint(str(tmp_path), 3, {"a": a}, async_=True)
    a.add_(1.0)
    t.join()
    restored, _ = restore_checkpoint(str(tmp_path), {"a": a})
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(100, dtype=np.float32))
    jrestored, _ = jrestore(str(tmp_path), {"a": jnp.zeros(100)})
    np.testing.assert_array_equal(np.asarray(jrestored["a"]),
                                  np.arange(100, dtype=np.float32))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.arange(4)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"a": torch.arange(4),
                                           "b": torch.arange(2)})
    with pytest.raises(ValueError):
        jrestore(str(tmp_path), {"a": jnp.arange(4), "b": jnp.arange(2)})
    with pytest.raises(ValueError, match="paths"):
        restore_checkpoint(str(tmp_path), {"b": torch.arange(4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": torch.arange(5)})


def test_restored_leaves_take_the_example_dtype_and_device(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": np.arange(4, dtype=np.int32),
                                       "x": np.ones(3, np.float32)})
    ex = {"a": torch.zeros(4, dtype=torch.int64),
          "x": torch.zeros(3, dtype=torch.float32, device="cpu")}
    got, _ = restore_checkpoint(str(tmp_path), ex)
    assert got["a"].dtype == torch.int64 and got["a"].tolist() == [0, 1, 2, 3]
    assert got["x"].device == ex["x"].device


# -------------------------------------------------------------------- loop
def _quad_step_fns():
    """The reference's quad problem in both packages, SGD(0.2)."""
    jtarget = jnp.asarray(TARGET)
    ttarget = torch.from_numpy(TARGET)
    jopt, topt = jsgd(0.2), sgd(0.2)

    def jstep(state, step):
        grads = jax.grad(lambda p: jnp.mean((p["w"] - jtarget) ** 2))(
            state["params"])
        p, o = jopt.update(grads, state["opt"], state["params"])
        return {"params": p, "opt": o}, jnp.mean((p["w"] - jtarget) ** 2)

    def tstep(state, step):
        grads = {"w": 2.0 * (state["params"]["w"] - ttarget)
                 / ttarget.numel()}
        p, o = topt.update(grads, state["opt"], state["params"])
        return {"params": p, "opt": o}, float(torch.mean((p["w"] - ttarget)
                                                         ** 2))

    def jinit():
        params = {"w": jnp.zeros((4, 8))}
        return {"params": params, "opt": jopt.init(params)}

    def tinit():
        params = {"w": torch.zeros((4, 8))}
        return {"params": params, "opt": topt.init(params)}

    return jstep, tstep, jinit, tinit


def test_loop_checkpoints_and_resumes_as_the_reference(tmp_path):
    jstep, tstep, jinit, tinit = _quad_step_fns()
    out = {}
    for name, step, init, loop, cfg_t in (
            ("port", tstep, tinit, run_training, LoopConfig),
            ("reference", jstep, jinit, jrun_training, JLoopConfig)):
        d = str(tmp_path / name)
        cfg = cfg_t(ckpt_dir=d, ckpt_every=5, max_steps=12, async_ckpt=False)
        rep1 = loop(cfg, init(), step)
        assert rep1.steps_run == 12 and rep1.resumed_from is None
        restored = []
        cfg2 = cfg_t(ckpt_dir=d, ckpt_every=5, max_steps=20, async_ckpt=True)
        rep2 = loop(cfg2, init(), step,
                    on_restore=lambda s: restored.append(1) or s)
        assert rep2.resumed_from == 12 and rep2.steps_run == 8
        assert restored == [1]
        assert rep2.losses[-1] < rep1.losses[0]
        assert sorted(os.listdir(d), key=lambda n: int(n[5:])) == [
            "step_5", "step_10", "step_12", "step_15", "step_20"]
        out[name] = rep1.losses + rep2.losses
    np.testing.assert_allclose(out["port"], out["reference"], rtol=1e-6)


def test_loop_in_memory_start_step_and_final_state():
    _, tstep, _, tinit = _quad_step_fns()
    rep = run_training(LoopConfig(ckpt_dir=None, max_steps=6), tinit(), tstep,
                       start_step=2)
    assert rep.steps_run == 4 and rep.resumed_from is None
    assert len(rep.losses) == 4 and rep.final_state is not None
    entered = []

    class Ctx:
        def __enter__(self):
            entered.append(1)

        def __exit__(self, *exc):
            return False

    run_training(LoopConfig(max_steps=3), tinit(), tstep,
                 step_context=Ctx)
    assert entered == [1, 1, 1]


def test_loop_straggler_escalates_to_on_relayout(tmp_path):
    calls = {"relayout": 0}

    def step_fn(state, step):
        time.sleep(0.02)
        return state, 0.0

    def on_relayout(state):
        calls["relayout"] += 1
        return state

    for loop, cfg_t, state in ((run_training, LoopConfig,
                                {"x": torch.zeros(1)}),
                               (jrun_training, JLoopConfig,
                                {"x": jnp.zeros(1)})):
        calls["relayout"] = 0
        cfg = cfg_t(ckpt_dir=str(tmp_path / loop.__module__), ckpt_every=100,
                    max_steps=8, step_deadline_s=0.001, max_strays=3,
                    async_ckpt=False)
        rep = loop(cfg, state, step_fn, on_relayout)
        assert rep.relayout_requests == calls["relayout"] == 2
        assert rep.stray_steps == 2


# ------------------------------------------------------------ the pipeline
def test_run_pipeline_eval_every_matches_reference(tmp_path):
    """``run_pipeline`` over the port's Pipeline (``eval_fn``,
    ``apply_plan``, ``on_relayout``, ``step_context``) against the
    reference's from the same init: losses within 1e-4, the eval history
    at the same steps with the same metrics; a second run resumes."""
    data = synth.generate_bipartite(40, 30, 400, seed=0)
    train, test = synth.train_test_split(data)
    kw = dict(arch="lightgcn", embed_dim=8, n_layers=1, base_batch=64,
              target_batch=128, microbatch=64, eval_k=10,
              eval_item_block=16)
    jpipe = jbuild_pipeline(JPipelineConfig(**kw), train, holdout=test)
    pipe = build_pipeline(PipelineConfig(**kw), train, holdout=test,
                          device="cpu")
    assert pipe.eval_fn is not None and pipe.shard is None
    assert pipe.sched.target_batch == jpipe.sched.target_batch
    assert pipe.out_dim() == jpipe.out_dim()
    assert pipe.steps_for_epochs(3) == jpipe.steps_for_epochs(3)
    params = params_from_jax(jax.tree.map(
        np.asarray, jpipe.init_state()["params"]), "cpu")
    pipe._state0 = {"params": params, "opt": pipe.opt.init(params)}
    reps = {}
    for name, p, run, cfg_t in (("port", pipe, run_pipeline, LoopConfig),
                                ("reference", jpipe, jrun_pipeline,
                                 JLoopConfig)):
        reps[name] = run(cfg_t(ckpt_dir=str(tmp_path / name), ckpt_every=10,
                               max_steps=4, async_ckpt=False, eval_every=2), p)
    got, want = reps["port"], reps["reference"]
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert [s for s, _ in got.eval_history] == [2, 4]
    for (_, m), (_, jm) in zip(got.eval_history, want.eval_history):
        assert sorted(m) == sorted(jm) == ["mrr", "ndcg@10", "recall@10"]
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4)
    again = run_pipeline(LoopConfig(ckpt_dir=str(tmp_path / "port"),
                                    ckpt_every=10, max_steps=6,
                                    async_ckpt=False), pipe)
    assert again.resumed_from == 4 and again.steps_run == 2
    with pipe.step_context():
        state = pipe.on_relayout(pipe.init_state())
    assert pipe.apply_plan(state) is not None and pipe.n_offloaded == 0

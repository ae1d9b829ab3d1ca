"""Sharded training through ``Run.fit()`` on spawned gloo ranks
(``torch_ranks``), held to the reference's single-device trajectory.

The reference's own sharded run cannot serve as the oracle on this JAX
(its ring's ``shard_map`` rejects the loop carry), so, as its acceptance
test does (``tests/test_distributed.py::
test_sharded_fit_matches_single_device_trajectory``), the sharded run is
held to the single-device one with the same global batch, from the same
init, within the reference's sharded tolerance (rtol 5e-3, atol 1e-5):

  * ``lightgcn-smoke`` at ``mesh.shape = (4,)``, 4 per shard = 16 global,
    6 steps: losses, plan (shards, global microbatch, LR), each rank's
    share of every row-sharded leaf and Adam moment between steps, the
    sharded top-K bit for bit the unsharded sweep's, evaluate() alike on
    every rank;
  * NGCF (the composed route under the ring) and GCN at P = 2;
  * int8 and top-k gradient compression and the int8 ring payload
    against the exact sharded run, within the reference's tolerances
    (``tests/test_compression.py::test_multidevice_compressed_parity_20_
    steps``); tables demoted to host memory bit for bit the all-device
    sharded run;
  * a checkpoint written at P = 4 (every leaf unsharded, by rank 0)
    restored at P = 2 and P = 1 bit for bit.
"""
import json

import jax
import numpy as np
import pytest

from repro.api import build as jbuild
from repro.api import get_preset as jget_preset
from repro_torch.api import build, get_preset
from repro_torch.optim.optimizers import tree_paths
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=5e-3, atol=1e-5)
# the reference acceptance test's overrides: 16 a step on one device, 4 a
# shard on four
BASE = {"plan.microbatch": 16, "plan.target_batch": 64,
        "plan.base_batch": 64, "plan.warmup_epochs": 0}
STEPS = 6


def _reference(overrides, path, steps=STEPS):
    """The reference's single-device run: its initial params saved to
    ``path`` for the ranks, its losses, LR and final params."""
    jrun = jbuild(jget_preset("lightgcn-smoke").override(overrides))
    flat = jax.tree_util.tree_flatten_with_path(jrun.state["params"])[0]
    np.savez(path, **{jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in flat})
    lr0 = jrun.pipeline.lr_for_epoch(0)
    losses = jrun.fit(steps=steps).losses
    params = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(jrun.state["params"])[0]}
    return {"losses": losses, "lr0": lr0, "params": params,
            "describe": jrun.describe()}


# ---------------------------------------------------------------- P = 4
@pytest.fixture(scope="module")
def fit4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit4")
    ref = _reference(BASE, tmp / "init.npz")
    sharded = {**BASE, "mesh.shape": [4], "mesh.axes": ["data"],
               "plan.microbatch": 4}
    ranks = run_ranks(tmp, 4, "sharded_fit", overrides=sharded,
                      params_npz=str(tmp / "init.npz"), steps=STEPS,
                      evaluate=True)
    return ref, ranks


def test_sharded_fit_follows_reference_single_device(fit4):
    ref, ranks = fit4
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], **TOL)


def test_sharded_plan_is_per_shard_with_the_global_lr(fit4):
    ref, ranks = fit4
    r = ranks[0]
    assert (r["shards"], r["microbatch"], r["global_microbatch"]) == \
        (4, 4, 16)
    assert r["lr0"] == ref["lr0"]
    lines = r["describe"].splitlines()
    assert lines[0] == ref["describe"].splitlines()[0]
    assert lines[1] == "  mesh=4 axes=data spmm=ring"
    assert "shards=4" in lines[2]


def test_each_rank_stores_its_share_between_steps(fit4):
    """Every row-sharded leaf (the tables and their Adam m and v) holds
    1/P of the rows and owns no more storage; the rest is whole."""
    _, ranks = fit4
    assert not any(r["storage_bad"] for r in ranks)


def test_sharded_final_params_follow_reference(fit4):
    """tests/test_torch_train.py's rule for Adam's params: atol 1e-5 but
    for at most 0.5 % of elements, each within steps x 2 x lr."""
    ref, ranks = fit4
    got = ranks[0]["params"]
    assert sorted(got) == sorted(ref["params"])
    for k, want in ref["params"].items():
        diff = np.abs(got[k] - want)
        assert (diff > 1e-5).mean() <= 0.005, (k, diff.max())
        assert diff.max() <= STEPS * 2 * 1e-3, (k, diff.max())
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][k], got[k])


def test_sharded_topk_equals_unsharded_and_ranks_evaluate_alike(fit4):
    _, ranks = fit4
    for r in ranks:
        s0, i0, s1, i1 = r["topk"]
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(s1, s0)
        assert r["metrics"] == ranks[0]["metrics"]
    assert all(0.0 <= v <= 1.0 for v in ranks[0]["metrics"].values())


# ---------------------------------------------------------------- P = 2
@pytest.mark.parametrize("arch", ["ngcf", "gcn"])
def test_other_archs_at_two_shards_follow_reference(arch, tmp_path):
    """NGCF under the ring takes the composed route (the reference's
    single-device run the fused one: the same function)."""
    base = {**BASE, "model.arch": arch}
    ref = _reference(base, tmp_path / "init.npz")
    ranks = run_ranks(tmp_path, 2, "sharded_fit",
                      overrides={**base, "mesh.shape": [2],
                                 "plan.microbatch": 8},
                      params_npz=str(tmp_path / "init.npz"), steps=STEPS)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], **TOL)
    assert not any(r["storage_bad"] for r in ranks)


# ------------------------------------------------ compression and tiers
COMP_OV = {"plan.target_batch": 64, "plan.microbatch": 4,
           "plan.warmup_epochs": 0, "data.edges": 1200, "mesh.shape": [4]}
TIERS = {"memory.topology": "h100-hbm-host"}
RUNS = {"exact": {}, "int8": {"compression.grads": "int8"},
        "topk": {"compression.grads": "topk", "compression.frac": 0.1},
        "ring_int8": {"compression.ring": "int8"},
        "device": TIERS,
        "demoted": {**TIERS, "memory.pins": {"_embed": "host"}}}
COMP_STEPS = 20


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs4")
    return run_ranks(tmp, 4, "sharded_runs",
                     runs={k: {**COMP_OV, **v} for k, v in RUNS.items()},
                     params_npz=None, steps=COMP_STEPS)


@pytest.mark.parametrize("name,rtol,atol", [("int8", 1e-3, 2e-4),
                                            ("topk", 5e-3, 2e-3),
                                            ("ring_int8", 2e-2, 5e-3)])
def test_compressed_sharded_runs_track_exact(runs4, name, rtol, atol):
    """The reference's tolerances for its 4-device compressed runs."""
    r = runs4[0]
    assert r[name] != r["exact"]
    np.testing.assert_allclose(r[name], r["exact"], rtol=rtol, atol=atol)
    assert all(x[name] == r[name] for x in runs4)


def test_compression_residuals_are_row_sharded(runs4):
    """The [P, *shape] residual stacks: each rank holds its [1, *shape]
    row (checked with every other leaf's share), whole when gathered."""
    for r in runs4:
        assert r["int8_storage_bad"] == r["topk_storage_bad"] == []
        ef = {k: v for k, v in r["int8_state"].items()
              if k.startswith("['comp']['ef']")}
        assert ef and all(v.shape[0] == 4 for v in ef.values())


def test_demoted_sharded_run_is_bitwise_the_device_run(runs4):
    for r in runs4:
        assert r["demoted_offloaded"] == 6 and r["device_offloaded"] == 0
        assert r["demoted"] == r["device"]
        for k, v in r["device_state"].items():
            np.testing.assert_array_equal(r["demoted_state"][k], v)
        assert r["demoted_storage_bad"] == []


# ---------------------------------------------------------------- elastic
@pytest.fixture(scope="module")
def saved4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    ckpt = str(tmp / "ckpt")
    ov = {**BASE, "mesh.shape": [4], "plan.microbatch": 4}
    whole = run_ranks(tmp, 4, "save_sharded", overrides=ov,
                      params_npz=None, steps=3, ckpt_dir=ckpt)
    return ckpt, whole


def test_checkpoint_written_whole_restores_at_two_shards(saved4, tmp_path):
    ckpt, whole = saved4
    for w in whole[1:]:
        assert w.keys() == whole[0].keys()
    with open(f"{ckpt}/step_3/manifest.json") as f:
        manifest = json.load(f)                # every leaf written whole
    assert manifest["paths"] == list(whole[0])
    assert manifest["shapes"] == [list(v.shape) for v in whole[0].values()]
    ov = {**BASE, "mesh.shape": [2], "plan.microbatch": 8}
    ranks = run_ranks(tmp_path, 2, "restore_sharded", overrides=ov,
                      ckpt_dir=ckpt)
    for rank, r in enumerate(ranks):
        assert r["step"] == 3 and r["storage_bad"] == []
        for k, v in whole[0].items():
            np.testing.assert_array_equal(r["whole"][k], v, err_msg=k)
            got = r["local"][k]
            if got.shape != v.shape:              # this rank's row block
                n = v.shape[0] // 2
                np.testing.assert_array_equal(got, v[rank * n:(rank + 1) * n])


def test_checkpoint_written_whole_restores_at_one_shard(saved4):
    ckpt, whole = saved4
    run = build(get_preset("lightgcn-smoke").override(BASE), device="cpu")
    run.resume(ckpt)
    assert run.step_count == 3
    got = {p: t.numpy() for p, t in tree_paths(run.state)}
    assert got.keys() == whole[0].keys()
    for k, v in whole[0].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

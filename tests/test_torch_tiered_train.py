"""Training with demoted leaves (``memory.executor.TieredExecutor``'s
``place``/``fetch``/``commit`` through ``Pipeline``) on the CPU against the
reference, at smoke size, from the reference's init.

Host-store behaviour is compared only on topologies whose tiers have no
JAX memory kind (``uniform``, ``dram-optane-appdirect``): on
``tpu-hbm-host`` the reference's CPU backend keeps a demoted leaf in its
``pinned_host`` memory kind instead (``memory/executor.py``'s docstring).

  * fp32 demotion changes nothing: the port's demoted run equals its
    all-device run bit for bit, follows the reference's demoted run, and
    ``on_relayout`` re-plans and re-places to the same results;
  * a demoted run resumes bit for bit from its own checkpoint, and from
    one the reference's ``Run.fit`` wrote;
  * the int8 store holds the reference's bytes and trains within its
    tolerance; the fp32 default on the same budget stays bitwise."""
import jax
import numpy as np
import pytest
import torch

from repro.api import build as jbuild
from repro.api import get_preset as jget_preset
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jbuild_pipeline
from repro_torch.api import build, get_preset
from repro_torch.convert import params_from_jax
from repro_torch.data import synth
from repro_torch.optim.compression import quantize_rows_int8
from repro_torch.optim.optimizers import tree_leaves, tree_paths
from repro_torch.pipeline import PipelineConfig, build_pipeline
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(embed_dim=16, n_layers=2, optimizer="adam", target_batch=64,
            base_batch=64, microbatch=64, warmup_epochs=0)
ARCHS = {"lightgcn": dict(arch="lightgcn"),
         "ngcf-fused": dict(arch="ngcf", hadamard="fused")}
TIERED = ("uniform", "dram-optane-appdirect")
STEPS = 4
# the reference's own smoke run (tests/test_compression.py::_OV)
_OV = {"loop.steps": 20, "plan.target_batch": 64, "plan.microbatch": 16,
       "plan.warmup_epochs": 0, "data.edges": 1200, "loop.ckpt_dir": None}


def _smoke_data():
    data = synth.generate_bipartite(64, 48, 512, seed=0)
    return synth.train_test_split(data, 0.1, seed=0)


def _option(topo, option):
    """The demoting memory option on ``topo``: a pin or a fast-tier
    capacity of 4 kB (the fast tier's own name)."""
    if option == "pins":
        return {"memory_pins": {"item_embed": "slow"}}
    fast = "fast" if topo == "uniform" else "dram"
    return {"memory_capacity": {fast: 4096}}


def _from_reference(pipe, jstate):
    """The port's placed state from the reference's params (fresh Adam
    state, as the reference's own init has)."""
    params = params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                             "cpu")
    return pipe.apply_plan({"params": params, "opt": pipe.opt.init(params)})


def _run(pipe, state, steps, start=0):
    losses = []
    for step in range(start, start + steps):
        state, loss = pipe.step_fn(state, step)
        losses.append(loss)
    return state, losses


def _equal(a, b) -> bool:
    la, lb = tree_paths(a), tree_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def _adam_close(got, want, steps, lr=1e-3):
    """tests/test_torch_train.py's rule for Adam's params: atol 1e-5 but
    for at most 0.5 % of elements, each within steps x 2 x lr."""
    want = dict(tree_paths(jax.tree.map(np.asarray, want)))
    for path, t in tree_paths(got):
        diff = np.abs(t.numpy() - want[path])
        assert (diff > 1e-5).mean() <= 0.005, (path, diff.max())
        assert diff.max() <= steps * 2 * lr, (path, diff.max())


@pytest.mark.parametrize("option", ["pins", "capacity"])
@pytest.mark.parametrize("topo", TIERED)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fp32_demotion_is_bitwise_and_follows_reference(arch, topo, option):
    train, _ = _smoke_data()
    kw = {**BASE, **ARCHS[arch], "memory_topology": topo,
          **_option(topo, option)}
    jpipe = jbuild_pipeline(JPipelineConfig(**kw), train)
    pipe = build_pipeline(PipelineConfig(**kw), train, device="cpu")
    fast = build_pipeline(PipelineConfig(**BASE, **ARCHS[arch]), train,
                          device="cpu")
    assert pipe.plan.plan.to_dict() == jpipe.plan.plan.to_dict()
    assert pipe.n_offloaded == jpipe.n_offloaded > 0
    assert pipe.executor._host_names == jpipe.executor._host_names
    jstate = jpipe.init_state()
    # the reference's host store holds numpy arrays; the port's host
    # tensors
    for prefix in ("params", "opt"):
        for kp, leaf in jax.tree_util.tree_flatten_with_path(
                jstate[prefix])[0]:
            name = prefix + jax.tree_util.keystr(kp)
            assert isinstance(leaf, np.ndarray) == \
                (name in pipe.executor._host_names)
    state = _from_reference(pipe, jstate)
    assert all(leaf.device.type == "cpu" for leaf in tree_leaves(state))
    state0 = _from_reference(fast, jstate)

    state, losses = _run(pipe, state, STEPS)
    state0, losses0 = _run(fast, state0, STEPS)
    jstate, jlosses = _run(jpipe, jstate, STEPS)
    assert losses == losses0
    assert _equal(state, state0)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _adam_close(state["params"], jstate["params"], STEPS)

    # re-layout: the same plan and placement again, the same next steps
    relaid = pipe.on_relayout(state)
    jrelaid = jpipe.on_relayout(jstate)
    assert pipe.plan.plan.to_dict() == jpipe.plan.plan.to_dict()
    assert pipe.n_offloaded == jpipe.n_offloaded
    assert pipe.executor._host_names == jpipe.executor._host_names
    assert _equal(relaid, state)
    relaid, more = _run(pipe, relaid, 2, start=STEPS)
    state0, more0 = _run(fast, state0, 2, start=STEPS)
    _, jmore = _run(jpipe, jrelaid, 2, start=STEPS)
    assert more == more0 and _equal(relaid, state0)
    np.testing.assert_allclose(more, jmore, rtol=1e-4)


def _tiered_spec(ckpt_dir=None, package=get_preset):
    return package("lightgcn-smoke").override({
        **_OV, "loop.steps": STEPS, "loop.ckpt_dir": ckpt_dir,
        "loop.ckpt_every": 2, "memory.topology": "uniform",
        "memory.pins": {"item_embed": "slow"}})


def test_demoted_run_resumes_bitwise(tmp_path):
    """Checkpointed after 2 steps and resumed for 2, a demoted run equals
    the uninterrupted one bit for bit; the restored leaves go back to the
    host store."""
    whole = build(_tiered_spec(), device="cpu")
    rep = whole.fit()
    first = build(_tiered_spec(str(tmp_path)), device="cpu")
    first.fit(steps=2)
    resumed = build(_tiered_spec(), device="cpu").resume(str(tmp_path))
    assert resumed.step_count == 2 and resumed.pipeline.n_offloaded == 3
    rest = resumed.fit(steps=2)
    assert rest.losses == rep.losses[2:]
    assert _equal(resumed.state, whole.state)


def test_reference_demoted_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint of a demoted run written by the reference's
    ``Run.fit`` restores into the port's placement, leaf for leaf, and
    the next two steps follow the reference's."""
    jrun = jbuild(_tiered_spec(str(tmp_path), jget_preset))
    jrun.fit(steps=2)
    run = build(_tiered_spec(), device="cpu").resume(str(tmp_path))
    assert run.step_count == 2 and run.pipeline.n_offloaded == 3
    want = dict(tree_paths(jax.tree.map(np.asarray, {
        k: jrun.state[k] for k in ("params", "opt")})))
    for path, leaf in tree_paths(run.state):
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    got = run.fit(steps=2).losses
    np.testing.assert_allclose(got, jrun.fit(steps=2).losses, rtol=1e-4)


# ------------------------------------------------------------- int8 store
_INT8 = dict(BASE, arch="lightgcn", memory_topology="uniform",
             memory_capacity={"fast": 4096})


def test_int8_store_holds_the_references_bytes():
    """Demoted tables under ``embed_store='int8'``: the stored int8 rows
    and scales equal the reference's ``quantize_rows_int8`` of the same
    tables, bit for bit; the state carries the dequantized view; the
    store's bytes equal the reference's."""
    train, _ = _smoke_data()
    kw = dict(_INT8, embed_store="int8")
    jpipe = jbuild_pipeline(JPipelineConfig(**kw), train)
    pipe = build_pipeline(PipelineConfig(**kw), train, device="cpu")
    jstate = jpipe.init_state()
    state = _from_reference(pipe, jstate)
    assert sorted(pipe.executor._int8) == sorted(jpipe.executor._int8) == \
        ["params['item_embed']", "params['user_embed']"]
    for name, (jq, jscale) in jpipe.executor._int8.items():
        store = pipe.executor._int8[name]
        np.testing.assert_array_equal(store.q.numpy(), jq)
        np.testing.assert_array_equal(store.scale.numpy(), jscale)
        assert pipe.executor.store_nbytes(name) == \
            jpipe.executor.store_nbytes(name)
        leaf = name.split("'")[1]
        np.testing.assert_array_equal(state["params"][leaf].numpy(),
                                      jstate["params"][leaf])
    assert pipe.executor.describe() == jpipe.executor.describe()
    # commit re-quantizes: after a step the stored rows are the step's
    # tables quantized (the numpy function of the reference's bits)
    state, _ = pipe.step_fn(state, 0)
    for name, store in pipe.executor._int8.items():
        leaf = state["params"][name.split("'")[1]].numpy()
        q, scale = quantize_rows_int8(leaf)
        np.testing.assert_array_equal(store.q.numpy(), q)
        np.testing.assert_array_equal(store.scale.numpy(), scale)


def _losses(spec, n=20):
    run = build(spec, device="cpu")
    return [run.step() for _ in range(n)], run


def test_int8_store_trains_within_the_references_tolerance():
    """tests/test_compression.py::test_int8_embed_store_trains_to_same_
    tolerance, on the port: 20 int8-store steps within rtol 2e-2 / atol
    5e-3 of the exact trajectory, the tables really int8 in the store
    (under half their dense bytes), and the fp32 default on the same
    tight budget bitwise equal to the all-device run."""
    tiered = {"memory.topology": "uniform",
              "memory.capacity": {"fast": 4096}}
    smoke = get_preset("lightgcn-smoke").override(_OV)
    exact, _ = _losses(smoke.override(tiered))
    device, _ = _losses(smoke, n=5)
    l_q, q = _losses(smoke.override({**tiered,
                                     "compression.embed_store": "int8"}))
    assert len(q.pipeline.plan.plan.demoted()) > 0
    assert len(q.pipeline.executor._int8) == 2
    for name in q.pipeline.executor._int8:
        dense = q.state["params"][name.split("'")[1]]
        assert q.pipeline.executor.store_nbytes(name) < \
            dense.numel() * dense.element_size() // 2
    np.testing.assert_allclose(l_q, exact, rtol=2e-2, atol=5e-3)
    assert exact[:5] == device


def test_forwards_fetch_demoted_leaves():
    """``embeddings``/``evaluate``/``recommend`` run over the fetched
    leaves: a demoted run's metrics and recommendations equal the
    all-device run's."""
    spec = get_preset("lightgcn-smoke").override(
        {**_OV, "loop.steps": 3})
    tiered = spec.override({"memory.topology": "uniform",
                            "memory.pins": {"_embed": "slow"}})
    a, b = build(spec, device="cpu"), build(tiered, device="cpu")
    assert b.pipeline.n_offloaded == 6
    a.fit()
    b.fit()
    assert a.evaluate() == b.evaluate()
    users = np.arange(16)
    for x, y in zip(a.recommend(users), b.recommend(users)):
        np.testing.assert_array_equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))

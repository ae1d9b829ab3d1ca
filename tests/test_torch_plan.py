"""The port's training planner (``repro_torch.pipeline.plan``) against the
reference's (``repro.pipeline.plan``) on the same state at smoke size:
profile names (``jax.tree_util.keystr`` paths, quote for quote), bytes,
quantized store bytes and access figures; and, for every placement
policy x each of the reference's four topologies x {LightGCN, NGCF fused,
NGCF composed (messages profiled), GCN} x {no option, an ``hbm_budget``,
a fast-tier ``capacity``, ``pins``, ``embed_store='int8'``}, the plan
(``Plan.to_dict()``), ``TrainPlan.describe()`` but for the ``impl=``
token, the derived microbatch and the derived eval batch.  The graph's
byte count is the reference's, with the port's real CSR bytes beside."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.large_batch import LargeBatchSchedule as JSchedule
from repro.memory import get_topology as jget_topology
from repro.optim import adam as jadam
from repro.pipeline import plan as jplan
from repro.pipeline.registry import get_model as jget_model
from repro.pipeline.sparse import BipartiteCSR as JBipartiteCSR
from repro_torch.convert import params_from_jax
from repro_torch.core.large_batch import LargeBatchSchedule
from repro_torch.data import synth
from repro_torch.memory import get_topology
from repro_torch.optim import adam
from repro_torch.pipeline import BipartiteCSR, get_model
from repro_torch.pipeline import plan
from torch_threads import one_torch_thread  # noqa: F401

TOPOLOGIES = ("dram-optane-appdirect", "dram-optane-memorymode",
              "tpu-hbm-host", "uniform")
POLICIES = ("all-fast", "all-slow", "exact", "greedy", "paper-recipe")
# arch id -> (model, NGCF Hadamard route, layers); NGCF and GCN at one
# layer keep the exact policy's 2^n subset walk short
ARCHS = {"lightgcn": ("lightgcn", "auto", 2),
         "ngcf-fused": ("ngcf", "fused", 1),
         "ngcf-composed": ("ngcf", "composed", 1),
         "gcn": ("gcn", "auto", 1)}
OPTIONS = ("none", "hbm_budget", "capacity", "pins", "int8")
EMBED_DIM = 16
BUDGET = 12_000            # bytes: below the smoke state's ~30 kB
TARGET = 150_528           # the FULL presets' target batch


def _masked(text):
    """``describe()`` lines with the kernel route's token masked: the port
    names its own (torch/cuda), the reference pallas/xla."""
    return [" ".join("impl=*" if w.startswith("impl=") else w
                     for w in line.split(" ")) for line in text.splitlines()]


@functools.lru_cache(maxsize=None)
def _states(arch_id):
    """(port, reference) tuples of (spec, graph, params, opt state) from
    the reference's init on the smoke graph."""
    arch, hadamard, layers = ARCHS[arch_id]
    data = synth.generate_bipartite(64, 48, 512, seed=0)
    train, _ = synth.train_test_split(data, 0.1, seed=0)
    jg = JBipartiteCSR(train.user, train.item, 64, 48, impl="xla",
                       hadamard=hadamard)
    g = BipartiteCSR(train.user, train.item, 64, 48, device="cpu",
                     hadamard=hadamard)
    jparams = jget_model(arch).init(jax.random.PRNGKey(0), 64, 48,
                                    EMBED_DIM, layers)
    jopt = jadam(1e-3).init(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    opt = adam(1e-3).init(params)
    return ((get_model(arch), g, params, opt),
            (jget_model(arch), jg, jparams, jopt), layers)


def _kwargs(option, topo):
    """The planner's keyword arguments for one option on ``topo``."""
    fast = topo.fast.name
    return {
        "none": {},
        "hbm_budget": {"hbm_budget": BUDGET},
        "capacity": {"topology": topo.with_capacity({fast: BUDGET})},
        "pins": {"pins": {"item_embed": "slow", "opt['t']": "fast"}},
        "int8": {"embed_store": "int8", "hbm_budget": BUDGET},
    }[option]


def _plan(ours: bool, arch_id, policy, topo_name, option):
    (spec, g, params, opt), (jspec, jg, jparams, jopt), layers = \
        _states(arch_id)
    arch = ARCHS[arch_id][0]
    if ours:
        topo = get_topology(topo_name)
        kw = {"topology": topo, **_kwargs(option, topo)}
        sched = LargeBatchSchedule(1e-3, 1024, TARGET)
        build, args, impl = plan.build_train_plan, (spec, params, opt, g), \
            "torch"
    else:
        topo = jget_topology(topo_name)
        kw = {"topology": topo, **_kwargs(option, topo)}
        sched = JSchedule(1e-3, 1024, TARGET)
        build, args, impl = jplan.build_train_plan, (jspec, jparams, jopt,
                                                     jg), "xla"
    try:
        tp = build(arch, *args, layers, EMBED_DIM, sched, impl,
                   policy=policy, **kw)
    except (MemoryError, ValueError) as e:
        return type(e).__name__
    free = tp.hbm_budget - tp.plan.hbm_used
    evb = (plan if ours else jplan).derive_eval_batch(
        free, args[0].out_dim(EMBED_DIM, layers), 20, 1024)
    return {"plan": tp.plan.to_dict(), "describe": _masked(tp.describe()),
            "microbatch": tp.microbatch, "global": tp.global_microbatch,
            "eval_batch": evb, "write_policy": tp.write_policy,
            "epochs": [tp.microbatches_for_epoch(e) for e in range(4)]}


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_train_plan_equals_reference(policy, topo, arch_id, option):
    got = _plan(True, arch_id, policy, topo, option)
    want = _plan(False, arch_id, policy, topo, option)
    assert got == want


@pytest.mark.parametrize("embed_store", ["fp32", "int8"])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_profiles_from_state_equal_reference(arch_id, embed_store):
    """Names quote for quote (``params['w1'][0]``, ``opt['m']['...']``,
    the 0-d ``opt['t']`` at 4 bytes), bytes, store bytes, reads, writes
    and access sizes; ``messages_l*`` only on NGCF's composed route."""
    (spec, g, params, opt), (jspec, jg, jparams, jopt), layers = \
        _states(arch_id)
    got = plan.profiles_from_state(params, opt, g, layers, spec, EMBED_DIM,
                                   embed_store=embed_store)
    want = jplan.profiles_from_state(jparams, jopt, jg, layers, jspec,
                                     EMBED_DIM, embed_store=embed_store)
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
    names = [p.name for p in got]
    assert "opt['t']" in names and \
        next(p for p in got if p.name == "opt['t']").nbytes == 4
    assert any(n.startswith("messages_l") for n in names) == \
        (arch_id == "ngcf-composed")


def test_graph_bytes_are_the_references_count():
    """``graph_nbytes`` is the reference's count (seven int32 arrays); the
    port holds its two row-pointer arrays as int64, (n_users + n_items +
    2) x 4 B more."""
    (_, g, _, _), (_, jg, _, _), _ = _states("lightgcn")
    assert g.csr_nbytes() == jg.csr_nbytes() == \
        4 * (5 * g.n_edges + g.n_users + g.n_items + 2)
    assert g.ring_nbytes() == jg.ring_nbytes() == 0
    assert g.graph_nbytes() == jg.graph_nbytes()
    assert g.port_csr_nbytes() - g.csr_nbytes() == \
        4 * (g.n_users + g.n_items + 2)
    assert plan.host_offload_sharding() is None


def test_apply_placements_wraps_the_executor():
    """``apply_placements`` places through a ``TieredExecutor``: the
    demoted leaves move to the host store and are counted."""
    (spec, g, params, opt), _, layers = _states("lightgcn")
    tp = plan.build_train_plan("lightgcn", spec, params, opt, g, layers,
                               EMBED_DIM, LargeBatchSchedule(1e-3, 64, 64),
                               "torch", topology="uniform",
                               pins={"item_embed": "slow"})
    state, moved = plan.apply_placements({"params": params, "opt": opt},
                                         tp.plan, device="cpu")
    assert moved == 3
    assert torch.equal(state["params"]["item_embed"], params["item_embed"])

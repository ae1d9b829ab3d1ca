"""The port's memory-tier subsystem against ``repro.memory``: presets field
for field, plans of every registered policy over every reference topology
equal as ``Plan.to_dict()``, the int8 row store bit for bit, and the
serving executor's facades."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import memory as jmem
from repro.optim.compression import dequantize_rows_int8 as jdequantize
from repro.optim.compression import quantize_rows_int8 as jquantize
from repro.pipeline import plan as jplan
from repro_torch import memory as mem
from repro_torch.optim.compression import (dequantize_rows_int8,
                                           quantize_rows_int8)
from repro_torch.pipeline import plan

REFERENCE_TOPOLOGIES = ("dram-optane-appdirect", "dram-optane-memorymode",
                        "tpu-hbm-host", "uniform")
POLICIES = ("all-fast", "all-slow", "exact", "greedy", "paper-recipe")


# ------------------------------------------------------------- topologies
@pytest.mark.parametrize("name", REFERENCE_TOPOLOGIES)
def test_reference_presets_equal_field_by_field(name):
    ours, theirs = mem.get_topology(name), jmem.get_topology(name)
    assert ours.name == theirs.name
    assert [dataclasses.asdict(t) for t in ours.tiers] == \
        [dataclasses.asdict(t) for t in theirs.tiers]
    assert ours.describe() == theirs.describe()
    assert ours.is_uniform == theirs.is_uniform


def test_registries_and_h100_preset():
    assert sorted(jmem.topology_names() + ["h100-hbm-host"]) == \
        mem.topology_names()
    assert mem.policy_names() == jmem.policy_names() == list(POLICIES)
    h100 = mem.get_topology("h100-hbm-host")
    assert h100.names == ("hbm", "host")
    assert (h100.fast.read_bw, h100.fast.write_bw, h100.fast.capacity) == \
        (3.35e12, 3.35e12, 80 * 10**9)
    assert (h100.slow.read_bw, h100.slow.write_bw) == (64e9, 64e9)
    assert mem.resolve_tier(h100, "slow") == "host"
    with pytest.raises(KeyError, match="unknown memory topology"):
        mem.get_topology("no-such")


# ------------------------------------------------------------------ plans
def _profile_sets(ours: bool):
    m = mem if ours else jmem
    p = plan if ours else jplan
    sets = {
        "gnn": m.gnn_recsys_profiles(5000, 3000, 80_000, 64, 2),
        "gnn-int8": m.gnn_recsys_profiles(5000, 3000, 80_000, 64, 2,
                                          embed_store="int8"),
        "gnn-fused": m.gnn_recsys_profiles(5000, 3000, 80_000, 64, 2,
                                           fused_messages=True),
        "serve": p.serving_profiles(4_000_000, 1_000_000, 256),
        "serve-cache": p.serving_profiles(4_000_000, 1_000_000, 256,
                                          cache_rows=1000),
        "serve-ann": p.serving_profiles(4_000_000, 1_000_000, 256,
                                        ann_index_bytes=50_000),
        "serve-both": p.serving_profiles(4_000_000, 1_000_000, 256,
                                         cache_rows=1000,
                                         ann_index_bytes=50_000),
    }
    return sets


def _place(m, policy, profs, topo, budget, pins):
    try:
        fast = m.get_topology(topo).fast.name
        return m.get_policy(policy)(profs, topo, budgets={fast: budget},
                                    pins=pins).to_dict()
    except (MemoryError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("topo", REFERENCE_TOPOLOGIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_plans_equal_reference(policy, topo):
    ours, theirs = _profile_sets(True), _profile_sets(False)
    assert [[dataclasses.asdict(p) for p in v] for v in ours.values()] == \
        [[dataclasses.asdict(p) for p in v] for v in theirs.values()]
    for key in ours:
        for budget in (1 << 40, 3_000_000, 600_000):
            for pins in (None, {"item_embed": "slow"}, {"graph": "fast"}):
                got = _place(mem, policy, ours[key], topo, budget, pins)
                want = _place(jmem, policy, theirs[key], topo, budget, pins)
                assert got == want, (key, budget, pins)


def test_quantized_table_bytes_and_eval_batch():
    for n, row in ((1, 4), (1000, 512), (7, 132)):
        assert mem.quantized_table_bytes(n, row) == \
            jmem.quantized_table_bytes(n, row)
    for free in (0, 10_000, 1 << 30):
        for k, blk, d in ((20, 1024, 128), (5, 16, 8)):
            assert plan.derive_eval_batch(free, d, k, blk) == \
                jplan.derive_eval_batch(free, d, k, blk)


# ------------------------------------------------------------ int8 store
def test_quantize_rows_int8_bitwise():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((300, 37)).astype(np.float32)
    table[3] = 0.0                                    # an all-zero row
    table[4] *= 1e-30
    q, scale = quantize_rows_int8(table)
    jq, jscale = jquantize(table)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    assert q.dtype == np.int8 and scale.shape == (300, 1)
    np.testing.assert_array_equal(dequantize_rows_int8(q, scale),
                                  jdequantize(jq, jscale))


# --------------------------------------------------------- the executor
def _serve_plan(m, pins):
    profs = (plan if m is mem else jplan).serving_profiles(
        400, 400, row=16, cache_rows=4)
    return m.get_policy("greedy")(profs, m.get_topology("uniform"),
                                  pins=pins)


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_executor_host_table_facades_match_reference(store):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((25, 4)).astype(np.float32)
    pins = {"serve/item_embed": "slow"}
    ours = mem.TieredExecutor(_serve_plan(mem, pins), embed_store=store,
                              device="cpu")
    theirs = jmem.TieredExecutor(_serve_plan(jmem, pins), prefixes=(),
                                 embed_store=store)
    assert ours.has_demotions == theirs.has_demotions
    assert dataclasses.asdict(ours._demoted_tier("serve/item_embed")) == \
        dataclasses.asdict(theirs._demoted_tier("serve/item_embed"))
    assert ours._demoted_tier("serve/user_embed") is None
    placed = ours.host_table("serve/item_embed", table)
    want = theirs.host_table("serve/item_embed", table)
    assert type(placed).__name__ == type(want).__name__
    assert placed.shape == want.shape and placed.nbytes == want.nbytes
    ids = np.asarray([3, 0, 24, 3])
    got = placed.take(ids)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.take(ids))
    np.testing.assert_array_equal(placed.block(ids).numpy(), want.block(ids))
    # the link counter: int8 rows plus one fp32 scale per row
    per_row = 4 + 4 if store == "int8" else 4 * 4
    assert placed.link_bytes == 2 * len(ids) * per_row
    assert ours.host_table("serve/user_embed", table) is table
    assert ours.store_nbytes("serve/item_embed") == \
        (placed.nbytes if store == "int8" else None)
    assert "demoted=1 (host-store)" in ours.describe()
    with pytest.raises(ValueError, match="embed_store"):
        mem.TieredExecutor(_serve_plan(mem, pins), embed_store="fp16")


def test_executor_cache_stats_and_describe():
    plan_ = _serve_plan(mem, {"serve/item_embed": "slow"})
    ex = mem.TieredExecutor(plan_, cache_rows=4, device="cpu")
    table = np.ones((25, 4), np.float32)
    placed = ex.host_table("serve/item_embed", table)
    assert isinstance(placed, mem.HotRowCache)
    placed.take([1, 2])
    ex.prefetch_rows("serve/item_embed", [3])
    ex.prefetch_rows("no-such-table", [0])               # no-op
    stats = ex.cache_stats()["serve/item_embed"]
    assert stats["misses"] == 2 and stats["fills"] == 3
    assert "cache[" in ex.describe()
    with pytest.raises(ValueError, match="cache_rows"):
        mem.TieredExecutor(plan_, cache_rows=-1)

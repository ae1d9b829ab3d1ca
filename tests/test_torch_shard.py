"""The host side of the port's sharded execution against the reference's,
in one process: ``ShardPlan`` (validation, properties, ``describe``,
``from_config``, ``shard_divisor``), ``NodePartition``, ``auto_axes``,
``parse_mesh``; ``bucket_edges`` bit for bit with the reference's and its
loop oracle, and the ring's own per-rank buckets holding the same edges;
the ring bytes the planner sees (``est_nbytes``); and ``build_train_plan``
at P = 2 and 4 against the reference's with the same ``ShardPlan``.

None of these needs a process group: a graph sizes its ring buckets
without one, and opens the group only when a ring first runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.large_batch import LargeBatchSchedule as JSchedule
from repro.dist import ring_spmm as jring
from repro.optim import adam as jadam
from repro.pipeline import plan as jplan
from repro.pipeline import shard as jshard
from repro.pipeline.registry import get_model as jget_model
from repro.pipeline.sparse import BipartiteCSR as JBipartiteCSR
from repro.pipeline.sparse import _RingGraph as JRingGraph
from repro_torch.convert import params_from_jax
from repro_torch.core.large_batch import LargeBatchSchedule
from repro_torch.data import synth
from repro_torch.dist import ring_spmm
from repro_torch.optim import adam
from repro_torch.pipeline import BipartiteCSR, get_model, plan, shard
from repro_torch.pipeline.sparse import _RingGraph
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(1,), (2,), (4,), (2, 2), (3,)]


def _plan_facts(mod, shape, spmm, steps, quant):
    p = mod.ShardPlan.from_config(shape, None, spmm, steps, quant)
    if p is None:
        return None
    return {"n": p.n_shards, "sharded": p.is_sharded, "ring": p.wants_ring,
            "dp": p.dp, "describe": p.describe(), "axes": p.axes,
            "divisor": [p.shard_divisor(s) for s in
                        ((8, 4), (6, 4), (8,), (4, 2, 3), (12, 1))]}


@pytest.mark.parametrize("spmm", [None, "ring"])
@pytest.mark.parametrize("shape", SHAPES)
def test_shard_plan_equals_reference(shape, spmm):
    for steps in (None, 1, 2):
        for quant in (False, True):
            assert _plan_facts(shard, shape, spmm, steps, quant) == \
                _plan_facts(jshard, shape, spmm, steps, quant)


@pytest.mark.parametrize("kw", [dict(shape=(2, 2), axes=("data",)),
                                dict(spmm="allgather"),
                                dict(ring_steps=0)])
def test_shard_plan_refuses_as_reference(kw):
    for mod in (shard, jshard):
        with pytest.raises(ValueError) as err:
            mod.ShardPlan(**kw)
        if mod is shard:
            msg = str(err.value)
        else:
            assert str(err.value) == msg


@pytest.mark.parametrize("p", [1, 2, 4])
def test_shard_state_keeps_each_ranks_row_block(p):
    """The reference's ``_leaf_sharding`` rule: a leaf with >= 2 dims and a
    leading dim divisible by P keeps this rank's row block (a copy, owning
    no more storage), any other leaf stays whole."""
    rng = np.random.default_rng(0)
    tree = {"t": torch.from_numpy(rng.standard_normal((8, 4))),
            "odd": torch.from_numpy(rng.standard_normal((6, 4))),
            "vec": torch.from_numpy(rng.standard_normal(8)),
            "cube": [torch.from_numpy(rng.standard_normal((4, 2, 3)))]}
    plan_t, plan_j = shard.ShardPlan((p,)), jshard.ShardPlan((p,))
    for rank in range(p):
        got = plan_t.shard_state(tree, rank)
        for name, whole, part in (("t", tree["t"], got["t"]),
                                  ("odd", tree["odd"], got["odd"]),
                                  ("vec", tree["vec"], got["vec"]),
                                  ("cube", tree["cube"][0], got["cube"][0])):
            n = plan_j.shard_divisor(tuple(whole.shape))
            rows = whole.shape[0] // n
            want = whole if n == 1 else whole[rank * rows:(rank + 1) * rows]
            torch.testing.assert_close(part, want, rtol=0, atol=0)
            if n > 1:
                assert part.untyped_storage().nbytes() == \
                    part.numel() * part.element_size(), name


@pytest.mark.parametrize("n,p", [(10, 4), (12, 4), (1, 1), (7, 3)])
def test_node_partition_equals_reference(n, p):
    part, jpart = shard.NodePartition(n, p), jshard.NodePartition(n, p)
    assert (part.n_pad, part.n_local) == (jpart.n_pad, jpart.n_local)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    padded = part.pad_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jpart.pad_rows(jnp.asarray(x))))
    np.testing.assert_array_equal(part.trim(padded).numpy(), x)
    # each rank's block of a table lifted at an offset into the padded
    # unified rows
    lifted = np.zeros((part.n_pad + 5, 3), np.float32)
    lifted[2:2 + n] = x
    for r in range(p):
        blk = part.block(torch.from_numpy(x), r, offset=2)
        np.testing.assert_array_equal(
            blk.numpy(), lifted[r * part.n_local:(r + 1) * part.n_local])


def test_auto_axes_and_parse_mesh_equal_reference():
    for s in SHAPES + [(2, 2, 2)]:
        assert shard.auto_axes(s) == jshard.auto_axes(s)
    for text in ("4", "2x2", "2X3x1"):
        assert shard.parse_mesh(text) == jshard.parse_mesh(text)
    for mod in (shard, jshard):
        with pytest.raises(ValueError, match="bad mesh spec"):
            mod.parse_mesh("4by4")


def _edges(n=40, e=300, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.standard_normal(e).astype(np.float32))


@pytest.mark.parametrize("coeff", [False, True])
@pytest.mark.parametrize("steps", [None, 1])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_bucket_edges_equal_reference_bitwise(p, steps, coeff):
    src, dst, c = _edges()
    kw = dict(coeff=c if coeff else None, n_steps=steps)
    got = ring_spmm.bucket_edges(src, dst, 40, p, **kw)
    for want in (jring.bucket_edges(src, dst, 40, p, **kw),
                 jring._bucket_edges_loop(src, dst, 40, p, **kw),
                 ring_spmm._bucket_edges_loop(src, dst, 40, p, **kw)):
        assert len(got) == len(want)
        for a, b in zip(got[:-1], want[:-1]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[-1] == want[-1]


def test_bucket_edges_refuse_a_ragged_graph():
    src, dst, _ = _edges(n=10)
    for fn in (ring_spmm.bucket_edges, ring_spmm._bucket_edges_loop,
               jring.bucket_edges):
        with pytest.raises(ValueError, match="not divisible"):
            fn(src, dst, 10, 4)


@pytest.mark.parametrize("steps", [None, 1])
@pytest.mark.parametrize("p", [2, 4])
def test_ring_buckets_hold_bucket_edges_edges(p, steps):
    """Each rank's per-step CSR holds exactly bucket [rank, k] of
    ``bucket_edges``, in its order stably sorted by local dst."""
    src, dst, _ = _edges()
    src_l, dst_l, mask, n_local = ring_spmm.bucket_edges(src, dst, 40, p,
                                                         n_steps=steps)
    for rank in range(p):
        ring = ring_spmm.RingSpmm(torch.from_numpy(src.astype(np.int64)),
                                  torch.from_numpy(dst.astype(np.int64)),
                                  n_local, p, rank, None, n_steps=steps)
        assert ring.steps == (p if steps is None else steps)
        for k in range(ring.steps):
            m = mask[rank, k]
            order = np.argsort(dst_l[rank, k][m], kind="stable")
            want_dst = dst_l[rank, k][m][order]
            want_src = src_l[rank, k][m][order]
            indptr = ring.indptr[k].numpy()
            got_dst = np.repeat(np.arange(n_local), np.diff(indptr))
            np.testing.assert_array_equal(got_dst, want_dst)
            np.testing.assert_array_equal(ring.src[k].numpy(), want_src)
            assert ring.indptr[k].dtype == torch.int64
            assert ring.src[k].dtype == torch.int32
        assert ring.ref_nbytes == src_l.nbytes + dst_l.nbytes + mask.nbytes


def _bipartite():
    data = synth.generate_bipartite(64, 48, 512, seed=0)
    return synth.train_test_split(data, 0.1, seed=0)[0]


@pytest.mark.parametrize("steps", [None, 1, 2])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_ring_bytes_are_the_references_count(p, steps):
    """``est_nbytes`` and, before any ring is built, ``ring_nbytes`` are
    the reference's formula (its padded cubes over all shards)."""
    if steps is not None and steps >= p:
        steps = None
    train = _bipartite()
    plan_t = shard.ShardPlan((p,), ("data",), "ring", steps)
    plan_j = jshard.ShardPlan((p,), ("data",), "ring", steps)
    ring = _RingGraph(plan_t, train.user, train.item, 64, 48, "cpu", None)
    jring_g = JRingGraph(plan_j, train.user, train.item, 64, 48)
    assert ring.est_nbytes() == jring_g.est_nbytes()
    assert ring.nbytes() == jring_g.nbytes()
    g = BipartiteCSR(train.user, train.item, 64, 48, device="cpu",
                     shard=plan_t)
    jg = JBipartiteCSR(train.user, train.item, 64, 48, impl="xla",
                       shard=plan_j)
    assert g.ring_nbytes() == jg.ring_nbytes()
    assert g.graph_nbytes() == jg.graph_nbytes()
    assert g.port_ring_nbytes() == 0          # nothing built yet


ARCHS = {"lightgcn": ("lightgcn", 2), "ngcf": ("ngcf", 1), "gcn": ("gcn", 1)}


def _masked(text):
    return [" ".join("impl=*" if w.startswith("impl=") else w
                     for w in line.split(" ")) for line in text.splitlines()]


def _sharded_plan(ours, arch_id, p, option):
    arch, layers = ARCHS[arch_id]
    train = _bipartite()
    jparams = jget_model(arch).init(jax.random.PRNGKey(0), 64, 48, 16,
                                    layers)
    kw = {"hbm_budget": 12_000} if option == "hbm_budget" else {}
    if ours:
        sp = shard.ShardPlan((p,), ("data",))
        g = BipartiteCSR(train.user, train.item, 64, 48, device="cpu",
                         shard=sp)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        tp = plan.build_train_plan(
            arch, get_model(arch), params, adam(1e-3).init(params), g,
            layers, 16, LargeBatchSchedule(1e-3, 1024, 150_528), "torch",
            shard=sp, **kw)
    else:
        sp = jshard.ShardPlan((p,), ("data",))
        g = JBipartiteCSR(train.user, train.item, 64, 48, impl="xla",
                          shard=sp)
        tp = jplan.build_train_plan(
            arch, jget_model(arch), jparams, jadam(1e-3).init(jparams), g,
            layers, 16, JSchedule(1e-3, 1024, 150_528), "xla", shard=sp,
            **kw)
    return {"plan": tp.plan.to_dict(), "describe": _masked(tp.describe()),
            "microbatch": tp.microbatch, "shards": tp.shards,
            "global": tp.global_microbatch,
            "epochs": [tp.microbatches_for_epoch(e) for e in range(3)],
            "fused": g.fused_hadamard}


@pytest.mark.parametrize("option", ["none", "hbm_budget"])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
@pytest.mark.parametrize("p", [2, 4])
def test_sharded_train_plan_equals_reference(p, arch_id, option):
    """Per-shard profiles (a row-sharded leaf at 1/P, the ring buckets at
    1/P, NGCF's composed messages at 1/P), ``shards = P`` and the
    microbatch derived from ``target_batch // P``."""
    got = _sharded_plan(True, arch_id, p, option)
    want = _sharded_plan(False, arch_id, p, option)
    assert got == want
    assert got["shards"] == p and got["fused"] is False
    assert f"shards={p}" in got["describe"][0]


def test_sharded_profiles_divide_row_sharded_leaves():
    train = _bipartite()
    sp = shard.ShardPlan((4,), ("data",))
    g = BipartiteCSR(train.user, train.item, 64, 48, device="cpu", shard=sp)
    params = get_model("gcn").init(0, 64, 48, 16, 1, device="cpu")
    whole = {p.name: p.nbytes for p in plan.profiles_from_state(
        params, {}, g, 1, get_model("gcn"), 16)}
    per = {p.name: p.nbytes for p in plan.profiles_from_state(
        params, {}, g, 1, get_model("gcn"), 16, shard=sp)}
    # tables and the [16, 16] weight row-shard; the [16] bias does not
    assert per["params['user_embed']"] * 4 == whole["params['user_embed']"]
    assert per["params['layers'][0]['w']"] * 4 == \
        whole["params['layers'][0]['w']"]
    assert per["params['layers'][0]['b']"] == whole["params['layers'][0]['b']"]
    assert per["graph/csr"] == g.csr_nbytes() + g.ring_nbytes() // 4

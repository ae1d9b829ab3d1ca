"""Tiered serving in the port against the reference: the ``HotRowCache`` on
one id trace (outputs, counters, slot map), a ``Recommender`` grid over
placement, table store, cache and ANN knobs, ``from_pipeline``, and the
service over an ANN recommender.  Integer-valued tables make the float32
dot products exact, so ids and scores hold bit for bit.

Cache counters are compared on the ``uniform`` topology only: its tiers
have no JAX memory kind, so the reference takes its host-store path as the
port always does.  On ``tpu-hbm-host`` the reference's CPU backend places
demoted tables on its ``pinned_host`` memory kind and builds no cache, so
there only ids and scores are compared."""
import numpy as np
import pytest
import torch

from repro.eval.recommender import Recommender as JRecommender
from repro.memory import HostResident as JHostResident
from repro.memory import HotRowCache as JHotRowCache
from repro.memory import QuantizedHostResident as JQuantizedHostResident
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jbuild_pipeline
from repro.serving import ManualClock as JManualClock
from repro.serving import RecommenderService as JRecommenderService
from repro_torch.convert import params_from_jax
from repro_torch.data import synth
from repro_torch.eval import Recommender, streaming_topk
from repro_torch.memory import (HostResident, HotRowCache,
                                QuantizedHostResident)
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.serving import ManualClock, RecommenderService

BOTH_SLOW = {"serve/user_embed": "slow", "serve/item_embed": "slow"}


def _tables(seed=0, nu=30, ni=50, d=16):
    rng = np.random.default_rng(seed)
    ue = rng.integers(-4, 5, (nu, d)).astype(np.float32)
    ie = rng.integers(-4, 5, (ni, d)).astype(np.float32)
    ne = nu * 3
    user = rng.integers(0, nu, ne)
    item = rng.integers(0, ni, ne)
    order = np.lexsort((item, user))
    user, item = user[order], item[order]
    indptr = np.searchsorted(user, np.arange(nu + 1))
    return ue, ie, indptr.astype(np.int64), item.astype(np.int64)


def _int8_exact(table: np.ndarray, seed: int) -> np.ndarray:
    """The table with one entry of each row set to +-127: its int8 row
    scale is then 1.0, so the int8 store round-trips it exactly and every
    dot product stays integer-valued (bit-exact) in both packages."""
    rng = np.random.default_rng(seed)
    out = table.copy()
    rows = np.arange(len(out))
    out[rows, rng.integers(0, out.shape[1], len(out))] = \
        rng.choice([-127.0, 127.0], len(out))
    return out


def _tail(describe: str) -> str:
    """The placement, cache and ANN fragments of ``describe()``."""
    return describe[describe.index("topology="):]


# ------------------------------------------------------------ HotRowCache
@pytest.mark.parametrize("n,rows,zipf_queries", [(60, 6, 30),
                                                  (400, 32, 300)])
@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_hot_row_cache_matches_reference_on_one_trace(store, n, rows,
                                                      zipf_queries):
    """Outputs bitwise, ``stats.to_dict()`` equal and the slot map equal
    after every query, through admissions, evictions (including a row
    admitted and displaced within one query, and frequency ties among the
    residents) and a prefill."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((n, 8)).astype(np.float32)
    if store == "int8":
        ours = HotRowCache(QuantizedHostResident(table, "cpu"), rows=rows)
        theirs = JHotRowCache(JQuantizedHostResident(table), rows=rows)
    else:
        ours = HotRowCache(HostResident(table, "cpu"), rows=rows)
        theirs = JHotRowCache(JHostResident(table), rows=rows)
    trace = [rng.integers(0, n, rng.integers(1, 2 * rows)) for _ in range(30)]
    trace += [np.asarray(rng.zipf(1.3, rows + 3) % n)
              for _ in range(zipf_queries)]
    trace.insert(10, np.arange(20, 22 + 2 * rows))   # a scan past the cache
    for step, ids in enumerate(trace):
        got = ours.take(ids)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), theirs.take(ids),
                                      err_msg=f"query {step}")
        assert ours.stats.to_dict() == theirs.stats.to_dict(), step
        np.testing.assert_array_equal(ours._slot_of, theirs._slot_of)
        np.testing.assert_array_equal(ours._slot_ids, theirs._slot_ids)
        if step == 40:
            ours.prefill(np.arange(10))
            theirs.prefill(np.arange(10))
    assert ours.stats.evictions > 0 and ours.stats.hits > 0
    assert ours.resident_rows == theirs.resident_rows == rows
    slots = np.nonzero(ours._slot_ids >= 0)[0]
    np.testing.assert_array_equal(ours._store[slots].numpy(),
                                  theirs._store[slots])


def test_fused_requires_device_resident_items():
    """``fused=True`` with a host-resident item table raises, as the
    reference's; auto mode takes the block-major sweep, equal to fused."""
    ue, ie, indptr, items = _tables()
    with pytest.raises(ValueError, match="fused"):
        streaming_topk(ue, HostResident(ie, "cpu"), 5, fused=True)
    kw = dict(seen_indptr=indptr, seen_items=items, user_batch=7,
              item_block=16)
    s, i = streaming_topk(ue, HostResident(ie, "cpu"), 5, **kw)
    s2, i2 = streaming_topk(ue, ie, 5, fused=True, device="cpu", **kw)
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_array_equal(s, s2)


# ------------------------------------------------------------ Recommender
GRID = [(pins, store, cache, ann)
        for pins in ("fast", "slow")
        for store in ("fp32", "int8")
        for cache in (0, 16)
        for ann in (None, 1.0, 0.25)]


@pytest.mark.parametrize("pins,store,cache,ann", GRID)
def test_recommender_grid_matches_reference(pins, store, cache, ann):
    ue, ie, indptr, items = _tables(seed=7, nu=40, ni=96)
    ue, ie = _int8_exact(ue, 1), _int8_exact(ie, 2)
    kw = dict(seen_indptr=indptr, seen_items=items, k=6, user_batch=8,
              item_block=32, topology="uniform", embed_store=store,
              cache_rows=cache, pins=BOTH_SLOW if pins == "slow" else None)
    if ann is not None:
        kw.update(ann=True, keep_frac=ann, ann_block=16)
    ours = Recommender(ue, ie, device="cpu", **kw)
    theirs = JRecommender(ue, ie, impl="xla", **kw)
    assert ours.plan.to_dict() == theirs.plan.to_dict()
    assert ours.n_offloaded == theirs.n_offloaded
    for a, b in ((ours.user_e, theirs.user_e), (ours.item_e, theirs.item_e)):
        assert isinstance(b, JHostResident) == isinstance(a, HostResident)
        if isinstance(a, HostResident):
            assert type(a).__name__ == type(b).__name__
    rng = np.random.default_rng(0)
    for _ in range(3):
        q = rng.integers(0, 40, 12)
        i_t, s_t = ours.recommend(q)
        i_j, s_j = theirs.recommend(q)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_array_equal(s_t, s_j)
        assert ours.cache_stats() == theirs.cache_stats()
    ours.prefill_cache()
    theirs.prefill_cache()
    assert ours.cache_stats() == theirs.cache_stats()
    assert _tail(ours.describe()) == _tail(theirs.describe())
    # every knob serves the exact, all-fast, uncached results
    if ann in (None, 1.0):
        plain = Recommender(ue, ie, device="cpu", **{
            k: v for k, v in kw.items()
            if k in ("seen_indptr", "seen_items", "k", "user_batch",
                     "item_block")})
        np.testing.assert_array_equal(plain.recommend(q)[0], i_t)
        np.testing.assert_array_equal(plain.recommend(q)[1], s_t)


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_recommender_on_tpu_preset_matches_reference_ids(store):
    """The default topology with both tables pinned slow.  The port serves
    them from its host store, behind a cache.  The reference's CPU backend
    puts them on its ``pinned_host`` memory kind instead — no facade, no
    cache — and its gathers then refuse the mixed memory spaces, so the
    ids and scores are held against the reference's all-fast placement of
    the same tables (placement never changes results)."""
    ue, ie, indptr, items = _tables(seed=9, nu=40, ni=96)
    ue, ie = _int8_exact(ue, 3), _int8_exact(ie, 4)
    kw = dict(seen_indptr=indptr, seen_items=items, k=6, user_batch=8,
              item_block=32, embed_store=store, ann=True, keep_frac=0.5,
              ann_block=16, cache_rows=16)
    ours = Recommender(ue, ie, device="cpu", pins=BOTH_SLOW, **kw)
    theirs = JRecommender(ue, ie, impl="xla", pins=BOTH_SLOW, **kw)
    assert ours.plan.to_dict() == theirs.plan.to_dict()
    assert ours.n_offloaded == 2
    assert isinstance(ours.item_e, HotRowCache)
    assert not isinstance(theirs.item_e, JHostResident)
    assert theirs.cache_stats() == {}
    q = np.asarray([0, 5, 39, 5, 17, 3, 22, 11, 30])
    i_t, s_t = ours.recommend(q)
    i_j, s_j = JRecommender(ue, ie, impl="xla", **kw).recommend(q)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(s_t, s_j)
    assert ours.cache_stats()["serve/item_embed"]["misses"] > 0


def test_recommender_from_pipeline_matches_reference():
    """A small LightGCN Pipeline in both packages from the reference's
    init (carried across as numpy): placement, ids and scores agree.  The
    forward sums in another order, so scores agree to rtol 1e-5 and ids
    everywhere but at near-ties."""
    data = synth.generate_bipartite(30, 25, 250, seed=2)
    train, _ = synth.train_test_split(data)
    kw = dict(arch="lightgcn", embed_dim=8, n_layers=1, base_batch=64,
              target_batch=64, microbatch=64)
    jpipe = jbuild_pipeline(JPipelineConfig(**kw), train)
    pipe = build_pipeline(PipelineConfig(**kw), train, device="cpu")
    jstate = jpipe.init_state()
    params = params_from_jax({k: np.asarray(v)
                              for k, v in jstate["params"].items()}, "cpu")
    state = {"params": params, "opt": pipe.opt.init(params)}
    for knobs in (dict(), dict(ann=True, keep_frac=1.0, ann_block=5)):
        ours = Recommender.from_pipeline(pipe, state, k=5, item_block=7,
                                         **knobs)
        theirs = JRecommender.from_pipeline(jpipe, jstate, k=5, item_block=7,
                                            **knobs)
        assert ours.device == torch.device("cpu")
        assert ours.plan.to_dict() == theirs.plan.to_dict()
        assert _tail(ours.describe()) == _tail(theirs.describe())
        users = np.arange(data.n_users)
        i_t, s_t = ours.recommend(users)
        i_j, s_j = theirs.recommend(users)
        np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-6)
        near = np.zeros(i_t.shape, bool)
        gap = np.abs(np.diff(s_j, axis=1)) <= 1e-5 * np.abs(s_j[:, 1:]) + 1e-6
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        near[:, -1] = True
        assert not ((i_t != i_j) & ~near).any()


# ---------------------------------------------------------------- service
def test_service_over_ann_recommender_matches_recommend_and_reference():
    """The service over a tiered, cached, pruned ANN recommender answers
    each request as a direct ``recommend`` of its batch does, and as the
    reference's service does on the same trace."""
    ue, ie, indptr, items = _tables(seed=17, nu=30, ni=80)
    kw = dict(seen_indptr=indptr, seen_items=items, k=5, user_batch=8,
              item_block=16, topology="uniform", pins=BOTH_SLOW,
              cache_rows=12, ann=True, keep_frac=0.5, ann_block=8)
    rec = Recommender(ue, ie, device="cpu", **kw)
    svc = RecommenderService(rec, max_batch=4, max_wait_us=200,
                             clock=ManualClock())
    jsvc = JRecommenderService(JRecommender(ue, ie, impl="xla", **kw),
                               max_batch=4, max_wait_us=200,
                               clock=JManualClock())
    users = [3, 11, 3, 29, 0, 7, 15, 22, 9]
    for uid in users:
        svc.submit(uid)
        jsvc.submit(uid)
    got, want = svc.drain(), jsvc.drain()
    assert [r.user_id for r in got] == users
    direct = Recommender(ue, ie, device="cpu", **kw)
    for lo in range(0, len(users), 4):
        ids, scores = direct.recommend(np.asarray(users[lo:lo + 4]))
        for row, r in enumerate(got[lo:lo + 4]):
            np.testing.assert_array_equal(r.ids, ids[row])
            np.testing.assert_array_equal(r.scores, scores[row])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.total_us == a.wait_us + a.service_us
    s = svc.stats()
    assert s["completed"] == len(users) and s["batches"] == 3
    assert s["cache_hit_rate"] == jsvc.stats()["cache_hit_rate"]
    assert set(s["cache_hit_rate"]) == {"serve/user_embed",
                                        "serve/item_embed"}
    assert "ann[" in svc.describe()

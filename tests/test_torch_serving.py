"""The port's Recommender, RecommenderService and request queue against
``repro.eval.Recommender`` / ``repro.serving``: same tables -> same ids
and scores (integer-valued tables, so bit for bit); the queue's
replay-determinism cases mirrored from tests/test_serving.py."""
import numpy as np
import pytest

from repro.eval.recommender import Recommender as JRecommender
from repro.serving import ManualClock as JManualClock
from repro.serving import RecommenderService as JRecommenderService
from repro.serving import RequestQueue as JRequestQueue
from repro_torch.eval import Recommender
from repro_torch.serving import (ManualClock, QueueFull, RecommenderService,
                                 RequestQueue, bucket_for)


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


# ------------------------------------------------------- coalescing queue
def test_bucket_ladder():
    assert [bucket_for(n, 64) for n in (1, 2, 3, 5, 9, 64)] == \
        [1, 2, 4, 8, 16, 64]
    assert bucket_for(65, 64) == 64                 # capped at max_batch
    with pytest.raises(ValueError, match="n >= 1"):
        bucket_for(0, 64)


def test_queue_two_trigger_dispatch_under_manual_clock():
    clock = ManualClock()
    q = RequestQueue(max_batch=4, max_wait_us=100, clock=clock)
    q.submit(7)
    assert not q.ready() and q.next_batch() is None  # neither trigger yet
    assert q.next_deadline_us() == 100
    clock.advance(99)
    assert not q.ready()
    clock.advance(1)                                 # deadline trigger
    assert q.ready()
    batch = q.next_batch()
    assert batch.user_ids == (7,) and batch.bucket == 1
    assert batch.wait_us == (100,)
    for uid in (1, 2, 3, 4):                         # occupancy trigger
        q.submit(uid)
    assert q.ready()
    batch = q.next_batch()
    assert batch.user_ids == (1, 2, 3, 4) and batch.occupancy == 1.0
    q.submit(5)
    q.submit(6)
    q.submit(8)
    batch = q.next_batch(force=True)                 # pad to bucket 4
    assert batch.bucket == 4 and batch.user_ids == (5, 6, 8, 0)
    assert len(batch.requests) == 3 and batch.occupancy == 0.75


def test_queue_backpressure_and_stats():
    q = RequestQueue(max_batch=2, max_wait_us=0, max_depth=3,
                     clock=ManualClock())
    for uid in range(3):
        q.submit(uid)
    with pytest.raises(QueueFull):
        q.submit(99)
    assert q.stats()["rejected"] == 1 and q.stats()["depth"] == 3
    q.next_batch()
    q.next_batch()
    s = q.stats()
    assert s["dispatched"] == 3 and s["batches"] == 2 and s["depth"] == 0
    assert 0.0 < s["mean_occupancy"] <= 1.0
    with pytest.raises(ValueError, match="max_depth"):
        RequestQueue(max_batch=8, max_depth=4)
    with pytest.raises(ValueError, match="max_batch"):
        RequestQueue(max_batch=0)
    with pytest.raises(ValueError, match="advance"):
        ManualClock().advance(-1)


def _play(queue_cls, clock_cls):
    clock = clock_cls()
    q = queue_cls(max_batch=4, max_wait_us=50, clock=clock)
    out = []
    for uid in [5, 3, 9, 1, 7, 2, 8, 4, 6]:
        q.submit(uid)
        clock.advance(17)
        b = q.next_batch()
        if b is not None:
            out.append((b.user_ids, b.bucket, b.t_dispatch_us,
                        tuple(r.req_id for r in b.requests)))
    while len(q):
        clock.advance(50)
        b = q.next_batch()
        if b is not None:
            out.append((b.user_ids, b.bucket, b.t_dispatch_us,
                        tuple(r.req_id for r in b.requests)))
    return out


def test_queue_determinism_same_trace_same_batches():
    """Batch composition is a pure function of the (trace, clock) pair,
    and the same as the reference queue's on the same trace."""
    first, second = _play(RequestQueue, ManualClock), \
        _play(RequestQueue, ManualClock)
    assert first == second and len(first) > 1
    assert first == _play(JRequestQueue, JManualClock)


# ------------------------------------------------------------ recommender
@pytest.mark.parametrize("k,item_block,user_batch", [(5, 16, 8), (12, 50, 3),
                                                     (60, 7, 30)])
def test_recommender_matches_reference(k, item_block, user_batch):
    ue, ie, indptr, items = _tables(seed=k)
    kw = dict(seen_indptr=indptr, seen_items=items, k=k,
              item_block=item_block, user_batch=user_batch)
    ours = Recommender(ue, ie, device="cpu", **kw)
    ref = JRecommender(ue, ie, impl="xla", **kw)
    users = np.array([3, 11, 3, 29, 0, 7, 15, 22, 9])
    for exclude in (True, False):
        i_t, s_t = ours.recommend(users, exclude_seen=exclude)
        i_j, s_j = ref.recommend(users, exclude_seen=exclude)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_array_equal(s_t, s_j)
    i_t, _ = ours.recommend(users, k=3)
    np.testing.assert_array_equal(i_t, ref.recommend(users, k=3)[0])
    with pytest.raises(ValueError, match="out of range"):
        ours.recommend([0, 30])
    assert "Recommender[30U x 50I]" in ours.describe()


@pytest.mark.parametrize("knob,error,match", [
    (dict(cache_rows=-4), ValueError, "cache_rows"),
    (dict(ann=True, keep_frac=0.0), ValueError, "keep_frac"),
    (dict(embed_store="fp16"), ValueError, "embed_store"),
    (dict(hbm_budget=16, pins={"serve/item_embed": "fast"}), MemoryError,
     "budget"),
    (dict(pins={"serve/item_embed": "nvme"}), ValueError, "unknown tier")])
def test_recommender_rejects_unported_knobs(knob, error, match):
    """Every knob of the reference's Recommender is ported now; each still
    rejects a value the reference rejects, with the same error type."""
    ue, ie, *_ = _tables()
    with pytest.raises(error, match=match):
        Recommender(ue, ie, device="cpu", **knob)
    with pytest.raises(error, match=match):
        JRecommender(ue, ie, impl="xla", **knob)


# ---------------------------------------------------------------- service
def test_service_end_to_end_matches_reference_service():
    ue, ie, indptr, items = _tables(seed=17)
    kw = dict(seen_indptr=indptr, seen_items=items, k=5, user_batch=8)
    svc = RecommenderService(Recommender(ue, ie, device="cpu", **kw),
                             max_batch=4, max_wait_us=200,
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
    assert [r.req_id for r in got] == [r.req_id for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.total_us == a.wait_us + a.service_us
    s = svc.stats()
    assert s["completed"] == len(users) and s["depth"] == 0
    assert s["batches"] == jsvc.stats()["batches"] == 3      # 4 + 4 + 1
    assert s["service_p50_us"] > 0 and s["total_p99_us"] >= s["total_p50_us"]
    assert s["cache_hit_rate"] == {}
    assert "RecommenderService[" in svc.describe()
    assert svc.clock.now_us() > 0          # virtual time advanced by compute


def test_service_backpressure_and_poll():
    ue, ie, *_ = _tables()
    svc = RecommenderService(Recommender(ue, ie, k=3, device="cpu"),
                             max_batch=1, max_depth=1, max_wait_us=0,
                             clock=ManualClock())
    svc.submit(0)
    with pytest.raises(QueueFull):
        svc.submit(1)
    assert len(svc.poll(force=True)) == 1
    assert svc.poll() == []

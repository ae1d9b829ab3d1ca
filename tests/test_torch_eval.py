"""The port's streaming top-K and metrics against ``repro.eval``: ids and
scores bitwise on integer-valued tables (forced ties), metrics equal,
out-of-range user ids rejected the same way, per-batch seen padding equal
to the reference's global padding."""
import numpy as np
import pytest
import torch

from repro.eval import metrics as jmetrics
from repro.eval import topk as jtopk
from repro_torch.eval import metrics, topk


def _tables(seed=0, nu=40, ni=70, d=16, ne=200):
    rng = np.random.default_rng(seed)
    ue = rng.integers(-3, 4, (nu, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (ni, d)).astype(np.float32)
    user = rng.integers(0, nu, ne)
    item = rng.integers(0, ni, ne)
    order = np.lexsort((item, user))
    user, item = user[order], item[order]
    indptr = np.searchsorted(user, np.arange(nu + 1)).astype(np.int64)
    return ue, ie, indptr, item.astype(np.int64)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("k,user_batch,item_block", [
    (5, 7, 16), (10, 40, 13), (1, 3, 70), (80, 11, 32),   # k > catalogue
])
def test_streaming_topk_bitwise_matches_reference(fused, k, user_batch,
                                                  item_block):
    ue, ie, indptr, items = _tables()
    users = np.array([3, 0, 39, 3, 17, 22, 8, 5, 11, 30, 2], np.int32)
    kw = dict(user_ids=users, seen_indptr=indptr, seen_items=items,
              user_batch=user_batch, item_block=item_block)
    s_t, i_t = topk.streaming_topk(torch.from_numpy(ue), torch.from_numpy(ie),
                                   k, fused=fused, **kw)
    s_j, i_j = jtopk.streaming_topk(ue, ie, k, impl="xla", **kw)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(s_t, s_j)
    assert s_t.dtype == np.float32 and i_t.dtype == np.int32


def test_streaming_topk_no_seen_all_users_and_numpy_tables():
    ue, ie, _, _ = _tables(seed=2)
    s_t, i_t = topk.streaming_topk(ue, ie, 6, user_batch=16, item_block=20,
                                   device="cpu")
    s_j, i_j = jtopk.streaming_topk(ue, ie, 6, user_batch=16, item_block=20,
                                    impl="xla")
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(s_t, s_j)
    s0, i0 = topk.streaming_topk(ue, ie, 6, user_ids=np.zeros(0, np.int32),
                                 device="cpu")
    assert s0.shape == (0, 6) and i0.shape == (0, 6)


def test_streaming_topk_real_valued_matches_reference():
    rng = np.random.default_rng(9)
    ue = rng.standard_normal((25, 12)).astype(np.float32)
    ie = rng.standard_normal((90, 12)).astype(np.float32)
    _, _, indptr, items = _tables(seed=9, nu=25, ni=90)
    kw = dict(seen_indptr=indptr, seen_items=items, user_batch=8,
              item_block=32)
    s_t, i_t = topk.streaming_topk(torch.from_numpy(ue), torch.from_numpy(ie),
                                   10, **kw)
    s_j, i_j = jtopk.streaming_topk(ue, ie, 10, impl="xla", **kw)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [-1, 40, 10**6])
def test_out_of_range_user_ids_rejected_like_reference(bad):
    ue, ie, _, _ = _tables()
    users = np.array([0, bad, 2], np.int32)
    with pytest.raises(ValueError) as jerr:
        jtopk.streaming_topk(ue, ie, 3, user_ids=users, impl="xla")
    with pytest.raises(ValueError) as terr:
        topk.streaming_topk(torch.from_numpy(ue), torch.from_numpy(ie), 3,
                            user_ids=users)
    assert str(terr.value) == str(jerr.value)


def test_per_batch_seen_padding_equals_global_padding():
    """The port pads each batch to its own largest degree; rows and masks
    equal the reference's global padding up to that width, and the extra
    global columns are all masked out."""
    _, _, indptr, items = _tables(seed=4)
    deg = np.diff(indptr)
    users = np.array([5, 1, 33, 20], np.int32)
    pad_global = int(deg.max())
    j_ids, j_mask = jtopk._padded_seen(users, indptr, items, pad_global)
    width = int(deg[users].max())
    t_ids, t_mask = topk._padded_seen(torch.from_numpy(users),
                                      torch.from_numpy(indptr),
                                      torch.from_numpy(items), width)
    np.testing.assert_array_equal(t_ids.numpy(), j_ids[:, :width])
    np.testing.assert_array_equal(t_mask.numpy(), j_mask[:, :width])
    assert not j_mask[:, width:].any()
    e_ids, e_mask = topk._padded_seen(torch.from_numpy(users),
                                      torch.from_numpy(indptr),
                                      torch.from_numpy(items), 0)
    assert e_ids.shape == (4, 0) and e_mask.dtype == torch.bool


def test_results_do_not_depend_on_batching():
    """Per-batch padding changes shapes only: any user_batch gives the same
    answer."""
    ue, ie, indptr, items = _tables(seed=6)
    kw = dict(seen_indptr=indptr, seen_items=items, item_block=16)
    ref = topk.streaming_topk(torch.from_numpy(ue), torch.from_numpy(ie), 7,
                              user_batch=40, **kw)
    for ub in (1, 3, 13):
        got = topk.streaming_topk(torch.from_numpy(ue), torch.from_numpy(ie),
                                  7, user_batch=ub, **kw)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_evaluate_embeddings_metrics_equal_reference():
    ue, ie, indptr, items = _tables(seed=8)
    rng = np.random.default_rng(8)
    test_pos = [rng.integers(0, 70, rng.integers(0, 4)) for _ in range(40)]
    kw = dict(seen_indptr=indptr, seen_items=items, user_batch=9,
              item_block=16)
    got = metrics.evaluate_embeddings(torch.from_numpy(ue),
                                      torch.from_numpy(ie), test_pos,
                                      ks=(5, 20), **kw)
    want = jmetrics.evaluate_embeddings(ue, ie, test_pos, ks=(5, 20),
                                        impl="xla", **kw)
    assert got == want
    empty = [np.zeros(0, np.int64)] * 40
    assert metrics.evaluate_embeddings(ue, ie, empty, k=5, device="cpu") == \
        jmetrics.evaluate_embeddings(ue, ie, empty, k=5, impl="xla")


def test_ranking_metrics_and_hits_equal_reference():
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 30, (50, 12)).astype(np.int32)
    test_pos = [rng.integers(0, 30, rng.integers(0, 6)) for _ in range(50)]
    np.testing.assert_array_equal(metrics.ranked_hits(ids, test_pos),
                                  jmetrics.ranked_hits(ids, test_pos))
    assert metrics.ranking_metrics(ids, test_pos, ks=(1, 5, 12, 40)) == \
        jmetrics.ranking_metrics(ids, test_pos, ks=(1, 5, 12, 40))
    with pytest.raises(ValueError, match="ranked rows"):
        metrics.ranked_hits(ids, test_pos[:3])

"""The top-K order of NaN and infinite scores against the reference's.

The reference merges with ``lax.top_k``, which orders by IEEE total order:
+NaN ranks above +inf (NaNs among themselves by payload), -NaN below -inf
and so below the (-inf, -1) seeds, so it never appears.  The port's
plain merge (``kernels.ref.merge_topk``), its plain fused sweep
(``fused_topk_score_ref``), ``streaming_topk`` on both routes and
``optim.compression.topk_sparsify`` are held to it here, bit for bit:
scores compared as their int32 bit patterns (``np.array_equal`` would
fail on NaN), ids exactly.  The fused cases are ``topk_nan_cases.py``'s;
``test_torch_cuda.py::test_fused_topk_kernel_matches_plain_on_nan`` holds
the CUDA kernel to the plain version on the card on the same cases (it
lives there because the card's machine has no JAX to import this file).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.eval import topk as jtopk
from repro.kernels import ref as jref
from repro.optim import compression as jcomp
from repro_torch.eval import topk
from repro_torch.kernels import ref
from repro_torch.optim import compression
from topk_nan_cases import BITS, CASES, fused_case
from topk_nan_cases import nan_bits as _f
from torch_threads import one_torch_thread  # noqa: F401


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_same(s_t, i_t, s_j, i_j):
    np.testing.assert_array_equal(np.asarray(i_t), np.asarray(i_j))
    np.testing.assert_array_equal(_bits(s_t), _bits(s_j))


def _jax_merge(carry_s, carry_i, scores, ids, k):
    """The reference's merge step (``repro/kernels/ref.py:128``)."""
    cat_s = jnp.concatenate([carry_s, scores], axis=1)
    cat_i = jnp.concatenate([carry_i, ids], axis=1)
    top_s, idx = jax.lax.top_k(cat_s, k)
    return top_s, jnp.take_along_axis(cat_i, idx, axis=1)


def _score_rows(case, rng, b=6, n=24):
    """[b, n] scores drawn from the case's pool of values."""
    pool = {"nan_inf": [_f(x) for x in BITS] + [1.0, -1.0, 0.0, 2.5, -7.0],
            "pos_nan": [_f("+nan"), _f("+nan_payload"), _f("+inf"), 3.0, 0.0],
            "neg_nan": [_f("-nan"), _f("-nan_payload"), _f("-inf"), -3.0,
                        1.0],
            "all_nan": [_f("+nan"), _f("-nan"), _f("+nan_payload"),
                        _f("-nan_payload")],
            "finite_ties": [1.0, 2.0, -1.0, 0.0]}[case]
    pool = np.array(pool, np.float32)
    return pool[rng.integers(0, len(pool), (b, n))]


@pytest.mark.parametrize("case", ["nan_inf", "pos_nan", "neg_nan", "all_nan",
                                  "finite_ties"])
@pytest.mark.parametrize("k", [1, 5, 30])
def test_merge_topk_orders_like_lax_top_k(case, k):
    rng = np.random.default_rng(k)
    b, n = 6, 24
    scores = _score_rows(case, rng, b, n)
    ids = np.broadcast_to(np.arange(10, 10 + n, dtype=np.int32), (b, n))
    # a carry of the seeds, then the result of a first merge as the carry
    carry_s = np.full((b, k), -np.inf, np.float32)
    carry_i = np.full((b, k), -1, np.int32)
    for blk in (scores[:, :n // 2], scores[:, n // 2:]):
        bid = ids[:, :blk.shape[1]]
        want = _jax_merge(jnp.asarray(carry_s), jnp.asarray(carry_i),
                          jnp.asarray(blk), jnp.asarray(bid), k)
        got = ref.merge_topk(torch.from_numpy(carry_s),
                             torch.from_numpy(carry_i),
                             torch.from_numpy(np.ascontiguousarray(blk)),
                             torch.from_numpy(np.ascontiguousarray(bid)), k)
        _assert_same(got[0], got[1], want[0], want[1])
        carry_s, carry_i = (np.asarray(want[0]), np.asarray(want[1]))
        ids = ids + n                       # the next block's ids are higher
    assert not (np.isnan(carry_s) & np.signbit(carry_s)).any()


def test_c1_reproduction():
    """ROADMAP §C1: one user row of ones, item rows [1, -NaN (0xFFC00000),
    3, 2], k = 4, item_block 2: ids [2, 3, 0, -1] in both packages (the
    -NaN never enters); with +NaN, [1, 2, 3, 0]."""
    seen = np.zeros((1, 0), np.int32)
    smask = np.zeros((1, 0), bool)
    for nan, want_ids in (("-nan", [2, 3, 0, -1]), ("+nan", [1, 2, 3, 0])):
        ue = np.ones((1, 4), np.float32)
        ie = np.array([[1.0] * 4, [_f(nan)] * 4, [3.0] * 4, [2.0] * 4],
                      np.float32)
        s_t, i_t = ref.fused_topk_score_ref(
            torch.from_numpy(ue), torch.from_numpy(ie),
            torch.from_numpy(seen), torch.from_numpy(smask), k=4,
            item_block=2, n_items=4)
        s_j, i_j = jref.fused_topk_score_ref(
            jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen),
            jnp.asarray(smask), k=4, item_block=2, n_items=4)
        np.testing.assert_array_equal(i_t.numpy(), [want_ids])
        _assert_same(s_t, i_t, s_j, i_j)
        for fused in (True, False):
            s_s, i_s = topk.streaming_topk(ue, ie, 4, item_block=2,
                                           fused=fused, device="cpu")
            _assert_same(s_s, i_s, s_j, i_j)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("item_block", [7, 16, 40])
def test_fused_topk_score_ref_matches_reference_on_nan(case, item_block):
    ue, ie, seen, mask, k, n = fused_case(case, np.random.default_rng(3))
    s_t, i_t = ref.fused_topk_score_ref(
        torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(seen),
        torch.from_numpy(mask), k=k, item_block=item_block, n_items=n)
    s_j, i_j = jref.fused_topk_score_ref(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen),
        jnp.asarray(mask), k=k, item_block=item_block, n_items=n)
    _assert_same(s_t, i_t, s_j, i_j)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fused", [True, False])
def test_streaming_topk_matches_reference_on_nan(case, fused):
    ue, ie, seen, mask, k, n = fused_case(case, np.random.default_rng(4))
    indptr = np.arange(0, seen.size + 1, seen.shape[1], dtype=np.int64)
    items = seen.reshape(-1).astype(np.int64)
    users = np.array([4, 0, 8, 1, 4, 2], np.int32)
    kw = dict(user_ids=users, seen_indptr=indptr, seen_items=items,
              user_batch=4, item_block=16)
    s_t, i_t = topk.streaming_topk(torch.from_numpy(ue), torch.from_numpy(ie),
                                   k, fused=fused, **kw)
    s_j, i_j = jtopk.streaming_topk(ue, ie, k, impl="xla", **kw)
    _assert_same(s_t, i_t, s_j, i_j)


@pytest.mark.parametrize("case", ["nan_inf", "all_nan"])
def test_topk_sparsify_orders_nan_magnitudes_like_reference(case):
    g = _score_rows(case, np.random.default_rng(5), 4, 10)
    for k in (1, 7, 40):
        v_t, i_t, r_t = compression.topk_sparsify(torch.from_numpy(g), k)
        v_j, i_j, r_j = jcomp.topk_sparsify(jnp.asarray(g), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(_bits(v_t), _bits(v_j))
        np.testing.assert_array_equal(_bits(r_t), _bits(r_j))

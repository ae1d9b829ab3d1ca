"""The port's coarse ANN kernel route, ``AnnIndex`` and ``ann_topk`` against
the reference's (``repro.kernels`` / ``repro.serving.ann``): the same numpy
inputs from a seed through both packages.  Integer-valued inputs make the
float32 dot products exact, so those cases hold bit for bit; real-valued
ones hold to rtol = atol = 1e-5 (fp32 sums in another order).  The
reference's own ANN tests (tests/test_serving.py) are mirrored on the
port."""
import math

import numpy as np
import pytest
import torch

from repro.eval.topk import streaming_topk as jstreaming_topk
from repro.kernels.ann import ann_block_scores_pallas
from repro.kernels.ref import ann_block_scores_ref as jann_block_scores_ref
from repro.serving import AnnIndex as JAnnIndex
from repro.serving import ann_topk as jann_topk
from repro_torch.eval import Recommender
from repro_torch.eval.topk import streaming_topk
from repro_torch.kernels import ops, ref
from repro_torch.pipeline.plan import serving_profiles
from repro_torch.serving import (AnnIndex, ann_index_nbytes, ann_topk,
                                 recall_against)

RTOL = ATOL = 1e-5


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


def _coarse_inputs(b, nb, d, integer, zero_radius, seed=0):
    rng = np.random.default_rng(seed)
    ue = rng.integers(-3, 4, (b, d)) if integer \
        else rng.standard_normal((b, d))
    cq = rng.integers(-127, 128, (nb, d)).astype(np.int8)
    scale = rng.random(nb).astype(np.float32) / 50
    radius = np.zeros(nb, np.float32) if zero_radius \
        else rng.random(nb).astype(np.float32)
    return ue.astype(np.float32), cq, scale, radius


# ------------------------------------------------------------- the kernel
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("zero_radius", [True, False])
@pytest.mark.parametrize("b,nb,d", [(1, 1, 8), (7, 13, 37), (64, 130, 128)])
def test_ann_block_scores_plain_matches_reference(b, nb, d, zero_radius,
                                                  integer):
    """The plain version (what the CPU runs and the card's kernel is held
    against) equals the reference's XLA oracle and its Pallas kernel in
    interpret mode.  Bitwise on integer-valued users with the radius
    zeroed (the affinity that block selection orders by float bits).
    With a radius, XLA's CPU backend contracts ``dots * scale + unorm *
    radius`` into one FMA while the port rounds the product first (as the
    CUDA kernel does), so there the two agree to rtol = atol = 1e-5, and
    the port is held bitwise to the unfused float32 formula instead."""
    ue, cq, scale, radius = _coarse_inputs(b, nb, d, integer, zero_radius,
                                           seed=b + nb + d)
    got = ops.ann_block_scores(*map(torch.from_numpy, (ue, cq, scale,
                                                       radius)))
    assert got.shape == (b, nb) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got, ref.ann_block_scores_ref(
        *map(torch.from_numpy, (ue, cq, scale, radius))).numpy())
    for want in (jann_block_scores_ref(ue, cq, scale, radius),
                 ann_block_scores_pallas(ue, cq, scale, radius,
                                         interpret=True)):
        want = np.asarray(want)
        if integer and zero_radius:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if integer:
        unfused = (ue @ cq.astype(np.float32).T) * scale[None] \
            + np.sqrt((ue * ue).sum(1, keepdims=True)) * radius[None]
        np.testing.assert_array_equal(got, unfused)


def _squares_summing_to(s, d):
    """Integer entries (greedy squares, zero-padded to d) whose squares sum
    to s."""
    row = []
    while s:
        a = math.isqrt(s)
        row.append(a)
        s -= a * a
    assert len(row) <= d
    return row + [0] * (d - len(row))


def test_ann_block_scores_plain_norm_is_correctly_rounded():
    """‖u‖₂ is correctly rounded: users whose sums of squares run over
    140..459 (147 is the first that ``torch.sqrt`` rounds one ulp high on
    some CPU builds), held bitwise to numpy's unfused formula with its
    correctly rounded ``np.sqrt``, radius on and off."""
    rng = np.random.default_rng(147)
    d, nb = 16, 9
    sums = np.arange(140, 460)
    ue = np.array([_squares_summing_to(int(s), d) for s in sums], np.float32)
    ue *= rng.choice(np.float32([-1, 1]), ue.shape)
    assert np.array_equal((ue * ue).sum(1), sums)
    cq = rng.integers(-127, 128, (nb, d)).astype(np.int8)
    scale = (rng.random(nb) / 50).astype(np.float32)
    for radius in (rng.random(nb).astype(np.float32),
                   np.zeros(nb, np.float32)):
        got = ref.ann_block_scores_ref(*map(torch.from_numpy,
                                            (ue, cq, scale, radius))).numpy()
        want = (ue @ cq.astype(np.float32).T) * scale[None] \
            + np.sqrt((ue * ue).sum(1, keepdims=True)) * radius[None]
        np.testing.assert_array_equal(got, want)


def test_ann_block_scores_route_rejects_cuda_on_cpu_tensors():
    ue, cq, scale, radius = _coarse_inputs(2, 3, 8, True, False)
    args = list(map(torch.from_numpy, (ue, cq, scale, radius)))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ann_block_scores(*args, impl="cuda")
    np.testing.assert_array_equal(ops.ann_block_scores(*args, impl="torch"),
                                  ops.ann_block_scores(*args))


# -------------------------------------------------------------- the index
@pytest.mark.parametrize("reorder", ["bisect", "none"])
@pytest.mark.parametrize("block", [16, 13])
def test_ann_index_build_matches_reference(reorder, block):
    rng = np.random.default_rng(block)
    ie = rng.standard_normal((200, 12)).astype(np.float32)
    ours = AnnIndex(ie, block=block, reorder=reorder, device="cpu")
    theirs = JAnnIndex(ie, block=block, reorder=reorder)
    for name in ("order", "centroids_q", "scale", "radius"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name), err_msg=name)
    assert (ours.n_blocks, ours.blk, ours.nbytes) == \
        (theirs.n_blocks, theirs.blk, theirs.nbytes)
    for frac in (0.1, 0.25, 1.0):
        assert ours.n_keep(frac) == theirs.n_keep(frac)
    ue = rng.integers(-3, 4, (9, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        ours.block_affinity(torch.from_numpy(ue), 7),
        theirs.block_affinity(ue, 7, impl="xla"))
    # the bound's radius term: XLA's CPU backend fuses it into an FMA
    np.testing.assert_allclose(ours.block_bounds(torch.from_numpy(ue), 7),
                               theirs.block_bounds(ue, 7, impl="xla"),
                               rtol=RTOL, atol=ATOL)
    aff = rng.standard_normal((5, ours.n_blocks)).astype(np.float32)
    aff[1, :4] = aff[0, :4]                           # cross-user ties
    for frac in (0.1, 0.25, 1.0):
        kept = ours.select_blocks(aff, frac)
        np.testing.assert_array_equal(kept, theirs.select_blocks(aff, frac))
        ids, n_valid = ours.candidate_ids(kept)
        want_ids, want_valid = theirs.candidate_ids(kept)
        np.testing.assert_array_equal(ids, want_ids)
        assert n_valid == want_valid
    assert ours.describe() == theirs.describe()


@pytest.mark.parametrize("keep_frac", [1.0, 0.25])
@pytest.mark.parametrize("with_seen", [True, False])
def test_ann_topk_matches_reference(keep_frac, with_seen):
    """Bitwise on integer tables; ``keep_frac=1.0`` also equals the port's
    exact sweep."""
    ue, ie, indptr, items = _tables(seed=11, nu=25, ni=70)
    kw = dict(user_batch=7, item_block=16)
    if with_seen:
        kw.update(seen_indptr=indptr, seen_items=items)
    qs = np.asarray([0, 3, 24, 3, 17, 8, 9, 1, 2, 22], np.int32)
    index = AnnIndex(ie, block=16, device="cpu")
    got_s, got_i = ann_topk(index, ue, ie, 5, keep_frac=keep_frac,
                            user_ids=qs, **kw)
    want_s, want_i = jann_topk(JAnnIndex(ie, block=16), ue, ie, 5,
                               keep_frac=keep_frac, user_ids=qs, impl="xla",
                               **kw)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    if keep_frac == 1.0:
        ex_s, ex_i = streaming_topk(ue, ie, 5, user_ids=qs, device="cpu",
                                    **kw)
        np.testing.assert_array_equal(got_i, ex_i)
        np.testing.assert_array_equal(got_s, ex_s)
        js, ji = jstreaming_topk(ue, ie, 5, user_ids=qs, impl="xla", **kw)
        np.testing.assert_array_equal(got_i, ji)


def test_ann_keep_all_when_candidates_outrun_merge_blocks():
    """A candidate matrix wider than the exact merge's padded blocks
    (4 index blocks of 8 = 32 slots over 25 items, merged in blocks of 7)
    still equals the exact sweep.  The reference's oracle cannot pad to
    that width (a negative pad), so this is held against the port's own
    exact sweep only."""
    ue, ie, indptr, items = _tables(seed=5, nu=12, ni=25)
    kw = dict(seen_indptr=indptr, seen_items=items, user_batch=5,
              item_block=7)
    index = AnnIndex(ie, block=8, device="cpu")
    assert index.n_keep(1.0) * index.blk > -(-25 // 7) * 7
    got = ann_topk(index, ue, ie, 5, keep_frac=1.0, **kw)
    want = streaming_topk(ue, ie, 5, device="cpu", **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------- mirrors of the reference tests
def test_ann_bound_dominates_member_scores():
    """block_bounds is a valid per-block score upper bound: no member's
    exact score exceeds its block's bound."""
    rng = np.random.default_rng(3)
    ie = rng.standard_normal((500, 12)).astype(np.float32)
    ue = rng.standard_normal((9, 12)).astype(np.float32)
    index = AnnIndex(ie, block=32, device="cpu")
    bounds = index.block_bounds(torch.from_numpy(ue), len(ue))
    exact = ue @ ie.T
    for b in range(index.n_blocks):
        members = index.order[b * index.blk:(b + 1) * index.blk]
        best = exact[:, members].max(axis=1)
        assert np.all(best <= bounds[:, b] + 1e-4), f"block {b}"


def test_ann_pruned_recall_floor_on_zipf_stream():
    """keep_frac=0.25 keeps recall@10 >= 0.95 against the exact sweep on a
    power-law stream over a clustered catalogue."""
    rng = np.random.default_rng(3)
    n_items, dim, nc = 8192, 16, 64
    centers = rng.normal(0, 1.0, (nc, dim)).astype(np.float32)
    ie = (centers[rng.integers(0, nc, n_items)]
          + 0.05 * rng.normal(0, 1, (n_items, dim))).astype(np.float32)
    ue = (centers[rng.integers(0, nc, 256)]
          + 0.3 * rng.normal(0, 1, (256, dim))).astype(np.float32)
    perm = rng.permutation(256)
    stream = perm[np.minimum(rng.zipf(1.3, 256) - 1, 255)][:64] \
        .astype(np.int32)
    index = AnnIndex(ie, block=32, device="cpu")
    _, exact_ids = streaming_topk(ue, ie, 10, user_ids=stream, user_batch=8,
                                  device="cpu")
    _, ann_ids = ann_topk(index, ue, ie, 10, keep_frac=0.25,
                          user_ids=stream, user_batch=8)
    rec = recall_against(exact_ids, ann_ids)
    assert rec >= 0.95, f"pruned recall@10 {rec:.3f} < 0.95"
    assert index.n_keep(0.25) < index.n_blocks
    assert recall_against(exact_ids, exact_ids) == 1.0


def test_ann_select_blocks_rank_voting_and_determinism():
    rng = np.random.default_rng(0)
    index = AnnIndex(rng.standard_normal((256, 8)).astype(np.float32),
                     block=8, device="cpu")             # 32 blocks
    aff = rng.standard_normal((4, index.n_blocks)).astype(np.float32)
    kept = index.select_blocks(aff, 0.25)           # n_keep = 8 >= batch
    assert np.array_equal(kept, index.select_blocks(aff.copy(), 0.25))
    assert np.array_equal(kept, np.sort(kept))      # ascending contract
    for u in range(4):                              # every argmax survives
        assert int(np.argmax(aff[u])) in kept
    # all-equal affinities: ties break toward lower block id
    flat = np.zeros((2, index.n_blocks), np.float32)
    np.testing.assert_array_equal(index.select_blocks(flat, 0.25),
                                  np.arange(8))


def test_ann_knob_validation_and_pricing():
    rng = np.random.default_rng(1)
    ie = rng.standard_normal((100, 8)).astype(np.float32)
    index = AnnIndex(ie, block=16, device="cpu")
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="keep_frac"):
            index.n_keep(bad)
    with pytest.raises(ValueError, match="reorder"):
        AnnIndex(ie, reorder="kmeans", device="cpu")
    assert ann_index_nbytes(100, 8, 16) == index.nbytes
    profs = serving_profiles(1000, 1000, row=32,
                             ann_index_bytes=index.nbytes)
    ann_prof = {p.name: p for p in profs}["serve/ann_index"]
    assert ann_prof.pinned == "fast" and ann_prof.nbytes == index.nbytes
    assert "serve/ann_index" not in {
        p.name for p in serving_profiles(1000, 1000, row=32)}
    rec = Recommender(ie[:50], ie, ann=True, ann_block=16,
                      topology="uniform", device="cpu")
    assert rec.plan.is_fast("serve/ann_index")
    with pytest.raises(ValueError, match="keep_frac"):
        Recommender(ie[:50], ie, ann=True, keep_frac=0.0,
                    topology="uniform", device="cpu")

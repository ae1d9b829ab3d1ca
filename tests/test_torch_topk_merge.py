"""The threshold-filtered, split-then-merge top-K behind the
``fused_topk_score`` kernel, on the CPU.

``replay`` runs the kernel's algorithm in numpy with the tile and split
sizes of ``kernels/topk_score.py`` (``ITEM_TILE``, ``split_plan``): each
split walks its item tiles in order and offers the tile's masked scores
(-0.0 made +0.0, ids >= n_items and live seen ids -inf), in groups of 32,
to each user's list, sorted by (score desc, id asc) and seeded with k
(-inf, -1) slots; a score goes in only if it is better than the list's
current k-th entry, the threshold, and is inserted at its rank (a group
with more than ``SORT_AT`` survivors goes in at once, as the kernel's
warp sort and merge does).  The merge then
starts from the first split's list and offers each later split's sorted
list in order, leaving it at its first entry that fails the threshold.
The kernel offers candidates in ascending id order; the replay also runs
them in descending order, where ties at the threshold with a lower id
must get in, and the result must not change.  Held bitwise (ids, and
scores by their bits) to the port's plain version and the reference's
XLA oracle on integer-valued inputs, and to the reference's Pallas
kernel in interpret mode on small cases.  Cases: k in {1, 20, 256, 300,
2000}, ties inside tiles and across split boundaries, -0.0, k larger than
the catalogue, fully masked users and D = 130, each at three split
counts (the split plans for 1, 3 and 132 SMs)."""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.topk_score import fused_topk_score_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.topk_score import (ITEM_TILE, SORT_AT, USER_TILE,
                                           blocks_per_sm, split_plan)

NEG_INF = np.float32(-np.inf)
SMS = (1, 3, 132)


def _key(s, i):
    """Sort key of (score desc, id asc): smaller is better."""
    return (-float(s), int(i))


def _offer(lst, s, i):
    """Offer (s, i) to the sorted list of (key, score, id); True if it beat
    the threshold (the last entry) and went in at its rank."""
    key = _key(s, i)
    if not key < lst[-1][0]:
        return False
    bisect.insort(lst, (key, s, i))
    lst.pop()
    return True


def _offer_group(lst, k, s, ids, lanes):
    """One warp's group of 32 candidates: those that beat the threshold at
    the group's start survive; more than SORT_AT survivors go in at once (a
    sort and merge), fewer one at a time in lane order, each checked
    against the threshold as it rises."""
    lanes = list(lanes)
    thr = lst[-1][0]
    live = [j for j in lanes if _key(s[j], ids[j]) < thr]
    if len(live) > SORT_AT:
        lst.extend((_key(s[j], ids[j]), s[j], ids[j]) for j in live)
        lst.sort()
        del lst[k:]
        return
    for j in live:
        _offer(lst, s[j], ids[j])


def _masked_scores(ue, table, seen_rows, n_items, lo, hi):
    """Scores of items [lo, hi) for one user: table rows past its end are
    zero (the plain version pads the table), -0.0 becomes +0.0, ids >=
    n_items and seen ids become -inf."""
    ids = np.arange(lo, hi)
    rows = np.zeros((hi - lo, table.shape[1]), np.float32)
    have = ids < table.shape[0]
    rows[have] = table[ids[have]]
    s = rows @ ue
    s = np.where(s == 0, np.float32(0), s).astype(np.float32)
    dead = (ids >= n_items) | np.isin(ids, seen_rows)
    return np.where(dead, NEG_INF, s), ids


def replay(ue, table, seen, mask, k, n_items, sms, descending=False):
    """(scores f32[B, k], ids i32[B, k]) by the kernel's algorithm."""
    b = ue.shape[0]
    splits, per = split_plan(b, n_items, k, sms)
    n_tiles = -(-n_items // ITEM_TILE)
    out_s = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    for u in range(b):
        seen_rows = seen[u][mask[u]]
        lists = []
        for sp in range(splits):                    # the partial kernel
            lst = [(_key(NEG_INF, -1), NEG_INF, -1)] * k
            tiles = range(sp * per, min(n_tiles, (sp + 1) * per))
            for tile in (reversed(tiles) if descending else tiles):
                lo = tile * ITEM_TILE
                s, ids = _masked_scores(ue[u], table, seen_rows, n_items, lo,
                                        lo + ITEM_TILE)
                groups = range(ITEM_TILE // 32)
                for g in (reversed(groups) if descending else groups):
                    lanes = range(32 * g, 32 * g + 32)
                    _offer_group(lst, k, s, ids,
                                 reversed(lanes) if descending else lanes)
            lists.append(lst)
        cur = list(lists[0])                         # the merge kernel
        rest = lists[:0:-1] if descending else lists[1:]
        for lst in rest:
            for _, s, i in lst:
                if not _offer(cur, s, i):
                    break          # sorted: nothing later beats it either
        out_s[u] = [s for _, s, _ in cur]
        out_i[u] = [i for _, _, i in cur]
    return out_s, out_i


def _case(case, k, seed):
    rng = np.random.default_rng(seed)
    b, ni, d, L = 70, 2600, 16, 40            # two user tiles, 21 item tiles
    ue = rng.integers(-2, 3, (b, d)).astype(np.float32)
    ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
    if case == "ties":                        # equal rows, three in a row
        ie = np.repeat(ie[: ni // 3 + 1], 3, axis=0)[:ni]
    elif case == "ties_across_splits":        # the same tile over and over
        ie = np.tile(ie[:ITEM_TILE], (-(-ni // ITEM_TILE), 1))[:ni]
    elif case == "neg_zero":
        ue = np.full((b, d), -1.0, np.float32)
        ie = np.abs(ie)                       # every score <= 0
        ie[::2] = 0.0                         # (-1) . 0 = -0.0 before canonical
    elif case == "k_gt_catalogue":
        ni = 6
        ie = ie[:ni]
    elif case == "fully_masked":
        ni = L = 300
        ie = ie[:ni]
    elif case == "ragged_d":
        d = 130
        ue = rng.integers(-2, 3, (b, d)).astype(np.float32)
        ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
    seen = rng.integers(0, ni, (b, L)).astype(np.int32)
    mask = rng.random((b, L)) < 0.5
    if case == "fully_masked":
        seen = np.broadcast_to(np.arange(ni, dtype=np.int32), (b, ni)).copy()
        mask[:] = False
        mask[: b // 2] = True                 # half the users see everything
    return ue, ie, seen, mask, k, ni


def _plain(ue, ie, seen, mask, k, ni):
    s, i = ref.fused_topk_score_ref(*map(torch.from_numpy, (ue, ie, seen, mask)),
                                    k=k, item_block=1000, n_items=ni)
    return s.numpy(), i.numpy()


def _same_bits(got, want):
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


CASES = ([("ties", k) for k in (1, 20, 256, 300, 2000)]
         + [("ties_across_splits", k) for k in (20, 300)]
         + [("neg_zero", 20), ("k_gt_catalogue", 11), ("fully_masked", 20),
            ("fully_masked", 300), ("ragged_d", 20)])


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case,k", CASES)
def test_replay_matches_plain_and_reference(case, k, sms):
    ue, ie, seen, mask, k, ni = _case(case, k, seed=k)
    got = replay(ue, ie, seen, mask, k, ni, sms)
    _same_bits(got, _plain(ue, ie, seen, mask, k, ni))
    js, ji = jref.fused_topk_score_ref(
        *map(jnp.asarray, (ue, ie, seen, mask)), k=k, item_block=1000,
        n_items=ni)
    _same_bits(got, (np.asarray(js), np.asarray(ji)))
    if case == "fully_masked":
        assert (got[1][: ue.shape[0] // 2] == -1).all()
    if case == "k_gt_catalogue":
        assert (got[1][:, ni:] == -1).all()
    if case == "neg_zero":
        fin = np.isfinite(got[0]) & (got[0] == 0)
        assert fin.any() and not np.signbit(got[0][fin]).any()


@pytest.mark.parametrize("case,k", [("ties", 20), ("ties", 2000),
                                    ("ties_across_splits", 300)])
def test_replay_is_order_free(case, k):
    """Offered in descending id order, ties at the threshold come with
    lower ids and must displace it; the result is the same bits."""
    ue, ie, seen, mask, k, ni = _case(case, k, seed=k + 1)
    want = replay(ue, ie, seen, mask, k, ni, sms=3)
    _same_bits(replay(ue, ie, seen, mask, k, ni, sms=3, descending=True),
               want)
    _same_bits(want, _plain(ue, ie, seen, mask, k, ni))


def test_threshold_admits_a_tie_with_a_lower_id_only():
    lst = [(_key(5.0, 10), np.float32(5.0), 10)] * 1
    assert not _offer(lst, np.float32(5.0), 12)
    assert _offer(lst, np.float32(5.0), 3) and lst[0][2] == 3
    assert not _offer(lst, NEG_INF, 0)


@pytest.mark.parametrize("k", [1, 20, 64, 256, 2000])
def test_split_plan_fills_the_card_and_covers_every_tile(k):
    for b, ni, sms in [(256, 53_248, 132), (64, 6_656, 132), (70, 2_600, 3),
                       (1, 1, 132), (5, 129, 1)]:
        splits, per = split_plan(b, ni, k, sms)
        n_tiles = -(-ni // ITEM_TILE)
        assert (splits - 1) * per < n_tiles <= splits * per
        if splits < n_tiles:
            assert -(-b // USER_TILE) * splits >= blocks_per_sm(k) * sms \
                or per > 1
    assert blocks_per_sm(20) == 2 and blocks_per_sm(256) == 1
    assert blocks_per_sm(2000) == 2          # lists in the global scratch


@pytest.mark.parametrize("case,k", [("ties", 20), ("ties", 300),
                                    ("ties_across_splits", 256)])
def test_replay_matches_pallas_interpret(case, k):
    ue, ie, seen, mask, k, ni = _case(case, k, seed=k + 2)
    ue, seen, mask = ue[:8], seen[:8], mask[:8]
    ni = 700
    ie = ie[:ni]
    got = replay(ue, ie, seen, mask, k, ni, sms=3)
    s_p, i_p = fused_topk_score_pallas(
        *map(jnp.asarray, (ue, ie, seen, mask)), k=k, item_block=256,
        n_items=ni, user_tile=4, interpret=True)
    _same_bits(got, (np.asarray(s_p), np.asarray(i_p)))

"""The numbers that decide ``correct`` and their judgement against the
limits of ``limits/<config>.<kind>.json``.

Training (the reference follows the program's first steps):
  loss_gap    worst |loss - ref| / |ref| over the followed steps;
  grad_gap    worst leaf's gap between the norms of the first gradient
              (program: Adam's first moment after one step / (1 - b1)),
              over the larger of that leaf's reference norm and the
              median leaf's;
  update_gap  the same for the change of the parameters over the steps;
  rows_gap    |rows the program's step took - the configuration's batch|.
Training, the end (the reference takes the program's last steps from a
copy of the state the window left):
  end_loss_gap    worst relative gap of those steps' losses;
  end_update_gap  worst leaf's gap between the norms of the change of the
                  parameters over them, as ``update_gap``.
  Leaves whose reference gradient (at the first step followed) is under a
  thousandth of the median leaf's move by round-off alone and are left
  out of the leaf gaps.
Serving (every answered request against the reference's top-K):
  rank_gap    worst (reference's j-th best score - reference score of the
              j-th served item) over the user's score RMS;
  score_gap   worst |served score - reference score of that item| / RMS;
  bad_answers served ids that are seen, repeated, out of range or out of
              (score desc, id asc) order, and answers for another user;
  unanswered  requests never answered, a minute past the window.
"""
from __future__ import annotations

import math
import statistics

SMALL_GRAD = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep: list[str]) -> float:
    med = statistics.median(ref.values())
    worst = 0.0
    for name in keep:
        worst = max(worst, abs(prog[name] - ref[name]) / max(ref[name], med))
    return worst


def loss_gap(losses: list, ref_losses: list) -> float:
    return max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(losses[:len(ref_losses)], ref_losses))


def moved_leaves(ref) -> list[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref.grad_norms.values())
    return [k for k, v in ref.grad_norms.items() if v >= SMALL_GRAD * med]


def train_numbers(losses: list, grad_norms: dict, change_norms: dict,
                  ref, rows_gap: int) -> dict:
    keep = moved_leaves(ref)
    return {"loss_gap": loss_gap(losses, ref.losses),
            "grad_gap": leaf_gaps(grad_norms, ref.grad_norms, keep),
            "update_gap": leaf_gaps(change_norms, ref.change_norms, keep),
            "rows_gap": float(rows_gap)}


def end_numbers(losses: list, change_norms: dict, ref) -> dict:
    return {"end_loss_gap": loss_gap(losses, ref.losses),
            "end_update_gap": leaf_gaps(change_norms, ref.change_norms,
                                        moved_leaves(ref))}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number at or under its limit; a missing
    or non-finite number fails."""
    checks, ok = {}, True
    for name, lim in limits["numbers"].items():
        v = numbers.get(name, math.nan)
        good = math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        checks[name] = {"value": v, "limit": lim["limit"]}
    return ok, checks


def serve_numbers(ue, ie, indptr, items, asked, users, ids, scores, k: int,
                  block: int = 2048) -> dict:
    """The serving numbers of answered requests.

    ue, ie: the reference's final embeddings (float32, on the device);
    indptr, items: its user-CSR of seen items; asked: the user each
    request asked for; users, ids, scores: what each answer says (its
    user, k item ids, k scores), numpy arrays of one row per answer."""
    import numpy as np
    import torch

    from perfbench.reference import topk as ref_topk

    dev = ue.device
    n_items = ie.shape[0]
    bad = int(np.sum(users != asked))
    rank_gap = score_gap = 0.0
    order = np.argsort(asked, kind="stable")
    asked_s = asked[order]
    uniq = np.unique(asked_s)
    for lo in range(0, len(uniq), block):
        ub = uniq[lo:lo + block]
        a = np.searchsorted(asked_s, ub[0], side="left")
        b = np.searchsorted(asked_s, ub[-1], side="right")
        rows = order[a:b]
        ub_t = torch.from_numpy(ub.astype(np.int64)).to(dev)
        sc = ue[ub_t] @ ie.T
        seen = ref_topk.seen_mask(ub_t, indptr, items, n_items)
        top_ids, top = ref_topk.topk(sc, seen, k)
        rms = sc.pow(2).mean(1).sqrt()
        r = torch.from_numpy(np.searchsorted(ub, asked[rows])).to(dev)
        s_ids = torch.from_numpy(ids[rows].astype(np.int64)).to(dev)
        s_sc = torch.from_numpy(scores[rows].astype(np.float32)).to(dev)
        invalid = s_ids < 0
        oob = s_ids >= n_items
        safe = torch.where(invalid | oob, torch.zeros_like(s_ids), s_ids)
        ref_s = sc[r[:, None], safe]
        ref_valid = top_ids[r] >= 0
        # a served slot left empty where the reference has an item
        empty_bad = invalid & ref_valid
        is_seen = seen[r[:, None], safe] & ~invalid
        srt = torch.sort(torch.where(invalid, -1 - torch.arange(
            k, device=dev).expand_as(s_ids), s_ids), 1).values
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        key = ref_topk.order_key(s_sc).to(torch.int64)
        kd, ka = key[:, :-1], key[:, 1:]
        ids_a, ids_b = s_ids[:, :-1], s_ids[:, 1:]
        out_of_order = ((kd < ka) | ((kd == ka) & (ids_a > ids_b))) \
            & ~invalid[:, 1:]
        bad += int(empty_bad.sum() + oob.sum() + is_seen.sum() + dup.sum()
                   + out_of_order.sum())
        norm = rms[r][:, None]
        live = ~invalid & ~oob
        gap = torch.where(live, (top[r] - ref_s) / norm,
                          torch.zeros_like(ref_s))
        sgap = torch.where(live, (s_sc - ref_s).abs() / norm,
                           torch.zeros_like(ref_s))
        rank_gap = max(rank_gap, float(gap.max()))
        score_gap = max(score_gap, float(sgap.max()))
    return {"rank_gap": rank_gap, "score_gap": score_gap,
            "bad_answers": float(bad)}

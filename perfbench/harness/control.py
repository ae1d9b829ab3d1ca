"""The control of ``correct``: the reference put in the program's place
and computed one precision below the configuration's (``control`` in
the limits file), judged by the same numbers against the float32
reference.  Its readings set the upper end of each limit; a sound
program's readings set the lower end."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference
from perfbench.harness import check, serve, train
from perfbench.reference import topk as ref_topk


def train_numbers(cell, inputs, seed: int, device,
                  end: "train.EndSteps | None" = None) -> dict:
    """The control's first steps from the seed; given ``end`` (a sound
    program's state at a window's end), also its end steps from there."""
    def pair(**kw):
        ref = train.reference_follow(cell.config, cell.mix, inputs, seed,
                                     device, **kw)
        ctl = train.reference_follow(cell.config, cell.mix, inputs, seed,
                                     device, precision=cell.limits["control"],
                                     **kw)
        return ref, ctl
    ref, ctl = pair()
    numbers = check.train_numbers(ctl.losses, ctl.grad_norms,
                                  ctl.change_norms, ref, 0)
    if end is not None:
        ref, ctl = pair(end=end)
        numbers.update(check.end_numbers(ctl.losses, ctl.change_norms, ref))
    return numbers


def serve_numbers(cell, inputs, seed: int, device, asked: np.ndarray,
                  k: int, block: int = 2048) -> dict:
    """The control answers every request in ``asked`` (user ids): its
    scores in the control's precision, its top-K by the same order."""
    ue, ie, indptr, items = serve.reference_embeddings(cell.config, inputs,
                                                       seed, device)
    prec = cell.limits["control"]
    dt = reference.dtype_of(prec)
    uniq, inv = np.unique(asked, return_inverse=True)
    ids = np.zeros((len(uniq), k), np.int64)
    scores = np.zeros((len(uniq), k), np.float32)
    with torch.no_grad(), reference.precision(prec):
        for lo in range(0, len(uniq), block):
            u = torch.from_numpy(uniq[lo:lo + block].astype(np.int64)).to(
                ue.device)
            sc = (ue[u].to(dt) @ ie.to(dt).T).float()
            seen = ref_topk.seen_mask(u, indptr, items, ie.shape[0])
            i, s = ref_topk.topk(sc, seen, k)
            ids[lo:lo + len(u)] = i.cpu().numpy()
            scores[lo:lo + len(u)] = s.cpu().numpy()
    return check.serve_numbers(ue, ie, indptr, items, asked, asked,
                               ids[inv], scores[inv], k)

"""Collectives over a run's process group, each the identity without one
(a single shard with no group open): the pieces of ``torch.distributed``
the sharded pipeline, the ring SpMM, the compressed gradient exchange and
the sharded top-K share."""
from __future__ import annotations

import torch
import torch.distributed as dist

# newer torch names the single-tensor collectives *_single and deprecates
# the *_tensor names that older builds have only
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def rank_of(group) -> int:
    return dist.get_rank(group) if group is not None else 0


def world_of(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] per rank -> [P·n, ...], rank blocks in rank order."""
    if group is None:
        return x
    out = x.new_empty((world_of(group) * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x.contiguous(), group=group)
    return out


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce (identity without a group); returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks whose backward reduce-scatters the
    cotangent, so each owner receives the sum of every rank's gradient of
    its rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, ct):
        p = world_of(ctx.group)
        out = ct.new_empty((ct.shape[0] // p,) + tuple(ct.shape[1:]))
        _reduce_scatter_single(out, ct.contiguous(), group=ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable ``all_gather_rows`` (identity without a group)."""
    return x if group is None else _GatherRows.apply(x, group)

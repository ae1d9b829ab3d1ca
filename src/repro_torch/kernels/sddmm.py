"""Per-edge sampled dense-dense op (SDDMM) — the wrapper of
``csrc/sddmm.cu``, the edge groups it walks, and the autograd Function
around both routes.

Replaces ``src/repro/kernels/sddmm.py:sddmm_pallas``.  One value per edge:

  * ``mul``  x[src] * y[dst]          f32[E, D]
  * ``add``  x[src] + y[dst]          f32[E, D]
  * ``dot``  <x[src], y[dst]>         f32[E]
  * ``copy`` coeff * x[src]           f32[E, D]  (coeff 1 when None)

and +0.0 on a masked edge.  It forms NGCF's per-layer Hadamard messages on
the seed COO path: one ``mul`` per layer at ``opt_level`` 3, two at 2
(``core/message_passing.py``).

Bound on the H100: memory.  The output is written once (E·D·4 bytes; 7.7 GB
per layer at the smoke's 15.08M edges, D = 128) and is most of the traffic;
the kernel stores it with streaming hints and loads the gathered rows
through the read-only path (the TPU kernel's nt-write intent, paper §6).
The edges lie in random order and the user table does not fit in L2, so
the kernel walks them grouped by one endpoint (``EdgeGroups``, built once
per graph by ``group_edges``: ``BipartiteGraph.user_groups``) and loads
that endpoint's row once per run of equal keys; without groups it walks
the edges in their own order.  The groups change the visiting order only:
every op gives the same bits with and without them.

The reference differentiates its XLA route by autodiff and has no Pallas
backward; the port's backward (``_Sddmm.backward``) is written out as
gathers and ``index_add_``, the same on both routes:

  * ``mul``:  dx = Σ_src g ⊙ y[dst],  dy = Σ_dst g ⊙ x[src]
  * ``add``:  dx = Σ_src g,           dy = Σ_dst g
  * ``dot``:  as ``mul`` with g_e broadcast over D
  * ``copy``: dx = Σ_src coeff·g,     dcoeff = Σ_D g ⊙ x[src]

with masked edges' cotangents zeroed first.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

OP_CODES = {"mul": 0, "add": 1, "dot": 2, "copy": 3}
# sorted positions per warp and edges in flight (csrc/sddmm.cu's kChunk,
# kUnroll); the CPU replay of the kernel's walk reads them
CHUNK = 256
UNROLL = 2


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeGroups:
    """A COO graph's edges grouped by one endpoint, the key: ``perm``
    i32[E] holds the edge ids stably sorted by key, and ``key_sorted``,
    ``other_sorted`` (i32[E]) and ``mask_sorted`` (u8[E]) the key, the
    other endpoint and the mask in that order.  ``key``, ``other`` and
    ``mask`` are the tensors the groups were built from; a call takes the
    groups only with those very tensors (same storage and length) as its
    indices and mask."""

    key: torch.Tensor
    other: torch.Tensor
    mask: torch.Tensor
    perm: torch.Tensor
    key_sorted: torch.Tensor
    other_sorted: torch.Tensor
    mask_sorted: torch.Tensor


def group_edges(key: torch.Tensor, other: torch.Tensor,
                edge_mask: torch.Tensor) -> EdgeGroups:
    """Group the edges by ``key``: one stable sort and three gathers on the
    tensors' device.  Counts its builds in ``group_edges.builds``."""
    perm = torch.sort(key, stable=True).indices
    live = edge_mask if edge_mask.dtype == torch.bool else edge_mask != 0
    group_edges.builds += 1
    return EdgeGroups(key, other, edge_mask, perm.to(torch.int32),
                      key[perm].contiguous(), other[perm].contiguous(),
                      live[perm].to(torch.uint8))


group_edges.builds = 0


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.device == b.device and a.data_ptr() == b.data_ptr() \
        and a.numel() == b.numel()


def grouped_operands(groups: EdgeGroups, op: str, x: torch.Tensor,
                     y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     edge_mask: torch.Tensor):
    """(grouped table, other table) of a call walked by ``groups``: (x, y)
    when the groups key ``src``, (y, x) when they key ``dst``.  Raises
    when the groups were built from other indices or another mask, and
    for 'copy' unless they key ``src``."""
    if not _same(groups.mask, edge_mask):
        raise ValueError("sddmm groups were built for another edge mask")
    if _same(groups.key, src) and _same(groups.other, dst):
        return x, y
    if op != "copy" and _same(groups.key, dst) and _same(groups.other, src):
        return y, x
    raise ValueError("sddmm groups do not belong to this call: their key "
                     "must be its src (or, except for 'copy', its dst) and "
                     "their other index the other one")


def _check_index(t: torch.Tensor, name: str, n: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
            or t.numel() != n:
        raise ValueError(f"{name} must be a contiguous int32 [E] tensor")


def sddmm_cuda(op: str, x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, edge_mask: torch.Tensor,
               coeff: torch.Tensor | None = None,
               groups: EdgeGroups | None = None) -> torch.Tensor:
    """x: f32[Nx, D]; y: f32[Ny, D]; src, dst: i32[E]; edge_mask: bool or
    integer [E] (nonzero = live); coeff: f32[E] or None (read by 'copy'
    only); groups: this call's ``EdgeGroups`` or None (edge order) ->
    f32[E, D], or f32[E] for 'dot'.  Indices are not range-checked."""
    if op not in OP_CODES:
        raise ValueError(op)
    if not x.is_cuda:
        raise ValueError("sddmm_cuda needs CUDA tensors")
    for t, name in ((x, "x"), (y, "y")):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [rows, D] "
                             "tensor")
    if y.shape[1] != x.shape[1]:
        raise ValueError("x and y must have the same width D")
    e, d = src.numel(), x.shape[1]
    _check_index(src, "src", e)
    _check_index(dst, "dst", e)
    if edge_mask.dim() != 1 or edge_mask.numel() != e:
        raise ValueError("edge_mask must be a [E] tensor")
    mask = edge_mask if edge_mask.dtype == torch.bool else edge_mask != 0
    mask = mask.contiguous()
    use_coeff = op == "copy" and coeff is not None
    if use_coeff and (coeff.dtype != torch.float32 or coeff.dim() != 1
                      or not coeff.is_contiguous() or coeff.numel() != e):
        raise ValueError("coeff must be a contiguous float32 [E] tensor")
    for t in (y, src, dst, mask, coeff if use_coeff else None):
        if t is not None and t.device != x.device:
            raise ValueError("every operand of sddmm must share a device")
    if groups is None:
        g_tab, o_tab = x, y
        perm, key, other, live = None, src, dst, mask
    else:
        g_tab, o_tab = grouped_operands(groups, op, x, y, src, dst,
                                        edge_mask)
        perm, key, other, live = (groups.perm, groups.key_sorted,
                                  groups.other_sorted, groups.mask_sorted)
    out = torch.empty((e,) if op == "dot" else (e, d), dtype=torch.float32,
                      device=x.device)
    if e == 0:
        return out
    vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, y, out))
    err = _build.entry("sddmm", "sddmm_f32")(
        OP_CODES[op], g_tab.data_ptr(), o_tab.data_ptr(),
        None if perm is None else perm.data_ptr(), key.data_ptr(),
        other.data_ptr(), live.data_ptr(),
        coeff.data_ptr() if use_coeff else None, out.data_ptr(), e, d,
        int(vec4), *_build.stream_of(x))
    if err:
        _build.check(_build.load("sddmm"), err, "sddmm")
    sddmm_cuda.launches += 1
    return out


sddmm_cuda.launches = 0


def _scatter(rows: torch.Tensor, index: torch.Tensor, like: torch.Tensor):
    return torch.zeros_like(like).index_add_(0, index, rows)


class _Sddmm(torch.autograd.Function):
    """``sddmm`` on the kernel (route 'cuda') or its plain version (route
    'torch', which ignores ``groups``), with the backward above; indices,
    the mask and the groups get no gradient."""

    @staticmethod
    def forward(ctx, op, x, y, src, dst, edge_mask, coeff, route,
                groups=None):
        if route == "cuda":
            out = sddmm_cuda(op, x, y, src, dst, edge_mask, coeff, groups)
        else:
            out = _ref.sddmm_ref(op, x, y, src, dst, edge_mask, coeff)
        ctx.op = op
        ctx.save_for_backward(x, y, src, dst, edge_mask,
                              coeff if op == "copy" else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, src, dst, edge_mask, coeff = ctx.saved_tensors
        op = ctx.op
        need_x, need_y, need_c = (ctx.needs_input_grad[1],
                                  ctx.needs_input_grad[2],
                                  ctx.needs_input_grad[6])
        mask = edge_mask.bool()
        g = torch.where(mask if g.dim() == 1 else mask[:, None], g, 0.0)
        if op == "dot":
            g = g[:, None]
        dx = dy = dc = None
        if op == "copy":
            if need_x:
                dx = _scatter(g if coeff is None else g * coeff[:, None], src,
                              x)
            if need_c and coeff is not None:
                dc = torch.sum(g * x.index_select(0, src), dim=-1)
        elif op == "add":
            if need_x:
                dx = _scatter(g, src, x)
            if need_y:
                dy = _scatter(g, dst, y)
        else:  # mul, dot
            if need_x:
                dx = _scatter(g * y.index_select(0, dst), src, x)
            if need_y:
                dy = _scatter(g * x.index_select(0, src), dst, y)
        return None, dx, dy, None, None, None, dc, None, None

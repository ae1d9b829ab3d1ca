"""Per-edge sampled dense-dense op (SDDMM) — the wrapper of
``csrc/sddmm.cu`` and the autograd Function around both routes.

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

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

OP_CODES = {"mul": 0, "add": 1, "dot": 2, "copy": 3}


def _check_index(t: torch.Tensor, name: str, n: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
            or t.numel() != n:
        raise ValueError(f"{name} must be a contiguous int32 [E] tensor")


def sddmm_cuda(op: str, x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, edge_mask: torch.Tensor,
               coeff: torch.Tensor | None = None) -> torch.Tensor:
    """x: f32[Nx, D]; y: f32[Ny, D]; src, dst: i32[E]; edge_mask: bool or
    integer [E] (nonzero = live); coeff: f32[E] or None (read by 'copy'
    only) -> f32[E, D], or f32[E] for 'dot'.  Indices are not range-checked."""
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
    out = torch.empty((e,) if op == "dot" else (e, d), dtype=torch.float32,
                      device=x.device)
    if e == 0:
        return out
    vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, y, out))
    lib = _build.load("sddmm")
    err = lib.sddmm_f32(
        OP_CODES[op], x.data_ptr(), y.data_ptr(), src.data_ptr(),
        dst.data_ptr(), mask.data_ptr(),
        coeff.data_ptr() if use_coeff else None, out.data_ptr(), e, d,
        int(vec4), x.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "sddmm")
    sddmm_cuda.launches += 1
    return out


sddmm_cuda.launches = 0


def _scatter(rows: torch.Tensor, index: torch.Tensor, like: torch.Tensor):
    return torch.zeros_like(like).index_add_(0, index, rows)


class _Sddmm(torch.autograd.Function):
    """``sddmm`` on the kernel (route 'cuda') or its plain version (route
    'torch'), with the backward above; indices and the mask get no
    gradient."""

    @staticmethod
    def forward(ctx, op, x, y, src, dst, edge_mask, coeff, route):
        if route == "cuda":
            out = sddmm_cuda(op, x, y, src, dst, edge_mask, coeff)
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
        return None, dx, dy, None, None, None, dc, None

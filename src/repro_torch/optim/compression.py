"""Compression primitives for the slow links (the port of
``repro/optim/compression.py``).

Every byte moved over a capacity-tier link is on the paper's critical
path, so gradients shrink two ways, both with error feedback so the
compression error is carried, not lost:

  * int8 stochastic-rounding quantization: q = round_s(g/scale), dequant;
  * top-k magnitude sparsification (k values + their indices).

Consumers: ``pipeline.compress.GradCompressor`` (the per-step gradient
combine, ``compression.grads``; on a sharded run through the collectives
``psum_int8_with_residual`` and ``topk_allgather_sum`` over the process
group), ``memory.executor.TieredExecutor`` (int8 storage of capacity-tier
tables, ``compression.embed_store``) and ``dist.ring_spmm`` (the int8 ring
payload, ``compression.ring``).

Randomness: the reference draws from ``jax.random`` keys, which torch
cannot reproduce, so stochastic rounding here takes a ``torch.Generator``
and the port's compressor keeps its own seed (``GradCompressor``).  The
row storage functions are numpy on the host, copied from the reference,
so a table quantized by either package stores the same bytes;
``quantize_rows_int8_tensor`` is the same arithmetic on a tensor's own
device, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.dist.collectives import all_gather_rows
from repro_torch.kernels.ref import order_key

__all__ = [
    "quantize_int8", "dequantize_int8", "compressed_psum_int8",
    "psum_int8_with_residual", "topk_sparsify", "topk_densify",
    "topk_allgather_sum",
    "quantize_rows_int8", "dequantize_rows_int8",
    "quantize_rows_int8_tensor", "ErrorFeedback", "make_topk_compressor",
    "make_int8_compressor", "wire_bytes",
]


def quantize_int8(g: torch.Tensor, generator: torch.Generator):
    """Symmetric per-tensor int8 with stochastic rounding: each element
    rounds up with probability equal to its fractional part, drawn from
    ``generator`` (which must live on ``g``'s device)."""
    scale = g.abs().max() / 127.0 + 1e-12
    return _round_stochastic(g, scale, generator).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _round_stochastic(g, scale, generator):
    """floor(g / scale) plus one with probability of the fraction."""
    x = g / scale
    lo = torch.floor(x)
    r = torch.rand(g.shape, generator=generator, device=g.device,
                   dtype=g.dtype)
    return lo + (r < x - lo)


def _shared_scale(g, group):
    """max|g| / 127 + 1e-12, max-reduced over the group so every
    participant dequantizes alike."""
    scale = (g.abs().max() / 127.0 + 1e-12).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    return scale


def compressed_psum_int8(g: torch.Tensor, generator: torch.Generator,
                         group) -> torch.Tensor:
    """Quantize -> all-reduce (int32 accumulate) -> dequantize, over
    ``group``.  Scales are max-reduced so every participant dequantizes
    consistently."""
    return psum_int8_with_residual(g, generator, group)[0]


def psum_int8_with_residual(g: torch.Tensor, generator: torch.Generator,
                            group):
    """``compressed_psum_int8`` that also returns the *local* residual
    ``g - dequant(q)`` — the error-feedback carry for the next step."""
    scale = _shared_scale(g, group)
    q = _round_stochastic(g, scale, generator)
    total = q.to(torch.int8).to(torch.int32)
    dist.all_reduce(total, group=group)
    return total.to(torch.float32) * scale, g - q * scale


def topk_allgather_sum(vals: torch.Tensor, idx: torch.Tensor, shape,
                       group) -> torch.Tensor:
    """The top-k exchange: all-gather every participant's (values,
    indices) — 2k entries per participant on the wire instead of the dense
    tensor — and densify-sum them, colliding indices accumulating."""
    return topk_densify(all_gather_rows(vals, group),
                        all_gather_rows(idx, group), shape)


def topk_sparsify(g: torch.Tensor, k: int):
    """Flatten, keep the k largest |.|, return (values, indices, residual).
    Magnitudes are ordered as ``lax.top_k`` orders them, by IEEE total
    order (``kernels.ref.order_key``: NaNs above +inf and among themselves
    by payload, where ``torch.sort`` ties them), and ties break toward the
    lower index (``torch.topk`` promises no order among ties): a stable
    descending sort keeps equal keys in index order."""
    flat = g.reshape(-1)
    order = torch.sort(order_key(flat.abs()), descending=True,
                       stable=True).indices
    idx = order[:k]
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return kept, idx, residual.reshape(g.shape)


def topk_densify(vals: torch.Tensor, idx: torch.Tensor,
                 shape) -> torch.Tensor:
    """The dense tensor holding ``vals`` at flat ``idx`` (colliding indices
    accumulate)."""
    size = 1
    for s in shape:
        size *= s
    out = torch.zeros(size, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals).reshape(tuple(shape))


class ErrorFeedback:
    """Carry compression residuals across steps: g_eff = g + e_{t-1};
    e_t = g_eff - decompress(compress(g_eff))."""

    @staticmethod
    def init(params):
        return tree_map(torch.zeros_like, params)

    @staticmethod
    def apply(grads, errors, compress_fn):
        """compress_fn(g) -> (g_hat, new_error); returns (g_hats, errors)."""
        pairs = [compress_fn(g + e) for g, e in zip(tree_leaves(grads),
                                                    tree_leaves(errors))]
        g_hats = iter([p[0] for p in pairs])
        new_e = iter([p[1] for p in pairs])
        return (tree_map(lambda _: next(g_hats), grads),
                tree_map(lambda _: next(new_e), grads))


def make_topk_compressor(frac: float):
    def compress(g):
        k = max(1, int(g.numel() * frac))
        vals, idx, residual = topk_sparsify(g, k)
        return topk_densify(vals, idx, g.shape), residual
    return compress


def make_int8_compressor(generator: torch.Generator):
    """An int8 compressor drawing its rounding from ``generator`` (the
    reference splits a key per call; one generator's stream serves)."""
    def compress(g):
        q, scale = quantize_int8(g, generator)
        g_hat = dequantize_int8(q, scale)
        return g_hat, g - g_hat
    return compress


# ---------------------------------------------------------------- storage
def quantize_rows_int8(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8, deterministic round-to-nearest.  Returns
    (q [N, D] int8, scale [N, 1] float32); the reconstruction error is at
    most scale/2 per element."""
    table = np.asarray(table, np.float32)
    scale = (np.abs(table).max(axis=-1, keepdims=True) / 127.0
             + 1e-12).astype(np.float32)
    q = np.clip(np.rint(table / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_rows_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


def quantize_rows_int8_tensor(table: torch.Tensor):
    """``quantize_rows_int8`` on the table's own device, the same bits:
    every step is one correctly rounded float32 operation as in numpy.
    The divisor 127 is a tensor, because torch divides by a Python scalar
    as a multiply by its reciprocal, which can differ in the last bit;
    ``torch.round`` rounds half to even, as ``np.rint`` does."""
    amax = table.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.round(table / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------- pricing
def wire_bytes(n_elements: int, scheme: str, frac: float = 0.01,
               dtype_bytes: int = 4) -> int:
    """Bytes one participant puts on the wire (or on the capacity tier)
    for an ``n_elements`` tensor under a compression scheme.  'int8' pays
    1 byte per element plus one fp32 scale; 'topk' pays (value + int32
    index) per kept entry; 'none'/'fp32' pay the dense dtype."""
    if scheme in ("none", "fp32"):
        return int(n_elements) * dtype_bytes
    if scheme == "int8":
        return int(n_elements) + 4
    if scheme == "topk":
        k = max(1, int(n_elements * frac))
        return k * (dtype_bytes + 4)
    raise ValueError(f"unknown compression scheme {scheme!r}; "
                     "known: none, int8, topk")

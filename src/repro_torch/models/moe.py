"""Sort-based top-k MoE dispatch (MegaBlocks-style, dense-capacity form)
— the port of ``repro/models/moe.py``, plain PyTorch as the reference is
plain JAX.

Tokens are sorted by expert id, a rank within each expert gives every
(token, slot) a capacity position, and overflow pairs go to a scratch row
(position C) that is sliced off: dropped pairs add zero.  Expert compute
is a batched matmul over the expert axis.  The reference's sharding hints
do nothing on one device and are left out.

The order of everything that picks or drops is the reference's, made
explicit where torch promises none: the top-k is ``lax.top_k``'s (value
descending, ties to the lower expert id: a stable descending sort of the
total-order keys, as ``optim.compression.topk_sparsify``), and the sort by
expert id is stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import order_key


class Dispatch(NamedTuple):
    """Where each (token, slot) pair goes.  ``topi`` [T, K] expert ids,
    ``topw`` [T, K] gate weights (x's dtype), ``order`` the stable sort of
    the flattened ids, ``pos_c`` [T*K] each sorted pair's capacity
    position (``cap`` where it is dropped), ``cap`` the capacity."""
    topi: torch.Tensor
    topw: torch.Tensor
    order: torch.Tensor
    pos_c: torch.Tensor
    cap: int


def top_k(logits: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis of float32 ``logits``: (values,
    ids), values descending, ties to the lower id."""
    ids = torch.sort(order_key(logits), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(logits, -1, ids), ids


def dispatch(cfg, xt: torch.Tensor, router: torch.Tensor) -> Dispatch:
    """Route xt [T, D]: float32 router, top-k, softmax over the k, then
    capacity positions by a stable sort and ``searchsorted``."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gate_logits = xt.to(torch.float32) @ router                      # [T, E]
    topw, topi = top_k(gate_logits, k)                               # [T, K]
    topw = torch.softmax(topw, dim=-1).to(xt.dtype)
    cap = int((t * k) / e * cfg.capacity_factor) + 1
    flat_e = topi.reshape(-1)                                        # [T*K]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank within expert = index - first occurrence of this expert id
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(t * k, device=xt.device) - first
    pos_c = torch.where(pos < cap, pos, cap)                         # overflow
    return Dispatch(topi, topw, order, pos_c, cap)


def moe_ffn(cfg, x: torch.Tensor, w) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] through top-k routed experts."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    r = dispatch(cfg, xt, w["router"])
    cap = r.cap
    flat_e = r.topi.reshape(-1)
    sorted_e = flat_e[r.order]
    tok_of = r.order // k
    # the scatters touch small int tables; D-wide data moves by gathers
    tok_table = torch.full((e, cap + 1), t, dtype=torch.long,
                           device=x.device)
    tok_table[sorted_e, r.pos_c] = tok_of                            # [E, C+1]
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])                   # row t = 0
    x_disp = xt_pad[tok_table[:, :cap]]                              # [E, C, D]

    if cfg.activation == "swiglu":
        up = torch.matmul(x_disp, w["w_up"])
        gate = F.silu(torch.matmul(x_disp, w["w_gate"]).to(torch.float32)
                      ).to(x.dtype)
        h = up * gate
    else:
        h = F.gelu(torch.matmul(x_disp, w["w_up"]).to(torch.float32),
                   approximate="tanh").to(x.dtype)
    y_exp = torch.matmul(h, w["w_down"])                             # [E, C, D]

    # combine: each (token, slot)'s capacity position, then its row
    pos_flat = torch.full((t * k,), cap, dtype=torch.long, device=x.device)
    pos_flat[r.order] = r.pos_c
    y_pad = torch.cat([y_exp, y_exp.new_zeros((e, 1, d))], dim=1)
    y_sorted = y_pad[flat_e, pos_flat]                               # [T*K, D]
    y = torch.sum(y_sorted.reshape(t, k, d) * r.topw[..., None], dim=1)

    if cfg.shared_experts:
        # shared expert: always-on FFN branch (no separate gate matrix)
        act = F.silu((xt @ w["ws_up"]).to(torch.float32)).to(x.dtype)
        y = y + act @ w["ws_down"]
    return y.reshape(b, s, d)


def load_balance_loss(gate_logits: torch.Tensor, topi: torch.Tensor,
                      e: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e (frac_tokens_e * mean_prob_e)."""
    probs = torch.softmax(gate_logits, -1)
    counts = torch.zeros(e, dtype=torch.float32, device=gate_logits.device)
    counts = counts.index_add(0, topi.reshape(-1),
                              torch.ones(topi.numel(), dtype=torch.float32,
                                         device=gate_logits.device))
    frac = counts / counts.sum()
    return e * torch.sum(frac * probs.mean(0))

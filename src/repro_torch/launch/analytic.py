"""Analytic FLOPs / HBM-traffic / collective-traffic model for LM cells —
the port of ``repro/launch/analytic.py``, the same formulas over the
port's ``TransformerConfig``.  A mesh is anything with a ``shape``
mapping of axis name to size (``launch/mesh.py``); one card is
``ONE_CARD`` (``{"data": 1, "model": 1}``).

Why this exists: XLA's HloCostAnalysis counts a while-loop *body once*,
not multiplied by trip count (verified empirically: a lax.scan of 10
matmuls reports the FLOPs of 1 — see EXPERIMENTS.md §Dry-run).  Every LM
cell is scan-over-layers (+ scan-over-microbatches + fori-loop flash
attention), so raw cost_analysis() under-reports by ~L*mb and the HLO
text shows loop collectives once.  Non-LM cells (GNN / recsys / NGCF)
contain no loops — their HLO numbers are used directly.

Conventions:
  * FLOPs: 2*M*N*K per matmul (matches XLA).  Train = fwd(2NT) +
    bwd(4NT) + remat re-forward(2NT) = 8NT on scan layers; lm_head is
    outside the remat scope -> 6NT.
  * Attention: our flash kernel computes full causal tiles (no
    above-diagonal skip) but *does* skip outside banded windows:
    S_vis = min(S, window + 2*k_chunk) for local/SWA layers.
  * Collective link-bytes (ring algorithms, logical buffer Z over axis k):
    all-gather (k-1)*Z, reduce-scatter (k-1)*Z, all-reduce 2(k-1)*Z.
  * HBM traffic: explicit per-term list, documented inline.  This is a
    ±20% model — good enough to rank roofline terms.
"""
from __future__ import annotations

from repro_torch.launch.mesh import ONE_CARD, dp_size  # noqa: F401


def _lm_dims(cfg):
    d, dh = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    attn_p = d * h * dh + 2 * d * kv * dh + h * dh * d
    n_mats = 3 if cfg.activation == "swiglu" else 2
    if cfg.is_moe:
        ffn_act = (cfg.top_k + cfg.shared_experts) * n_mats * d * cfg.moe_d_ff
        ffn_stored = (cfg.n_experts + cfg.shared_experts) * n_mats * d * cfg.moe_d_ff \
            + d * cfg.n_experts
    else:
        ffn_act = ffn_stored = n_mats * d * cfg.d_ff
    return attn_p, ffn_act, ffn_stored


def _s_vis(cfg, s, k_chunk=1024):
    """Average visited kv positions per query across layers."""
    full = s
    banded = min(s, cfg.window + 2 * k_chunk)
    if cfg.attn_type == "swa":
        return banded
    if cfg.attn_type == "local_global":
        return (banded + full) / 2
    return full


def _attn_flops_per_layer(cfg, b, s, s_vis):
    # QK^T + PV, grouped GQA: 2 matmuls x 2*B*H*dh*S*S_vis
    return 2 * 2 * b * cfg.n_heads * cfg.head_dim * s * s_vis


def lm_train_cost(cfg, shape, mesh):
    b, s = shape["global_batch"], shape["seq_len"]
    mb = shape.get("microbatches", 1)
    t = b * s
    t_mb = t // mb
    dp = dp_size(mesh)
    tp = mesh.shape["model"]
    attn_p, ffn_act, ffn_stored = _lm_dims(cfg)
    l = cfg.n_layers
    d, v = cfg.d_model, cfg.vocab
    p_layer_act = attn_p + ffn_act
    p_stored = l * (attn_p + ffn_stored) + 2 * v * d
    s_vis = _s_vis(cfg, s)

    # ---- FLOPs
    matmul = 8 * l * p_layer_act * t + 6 * (d * v) * t
    attn = 4 * l * _attn_flops_per_layer(cfg, 1, s, s_vis) * b
    flops = matmul + attn

    # ---- HBM bytes (global, per step)
    pb = 2  # bf16 params
    param_traffic = 3 * mb * (l * (attn_p + ffn_stored) * pb)  # fwd+bwd+remat weight reads
    grad_traffic = 4 * p_stored * 4          # f32 grads: acc read+write, opt read
    opt_traffic = 2 * p_stored * 4           # optimizer state r/w (adam ~4x this; adafactor ~0)
    act_bytes_layer = t_mb * (6 * d + (cfg.n_heads + 2 * cfg.n_kv_heads)
                              * cfg.head_dim + 2 * (ffn_act // d)) * 2
    act_traffic = 3 * mb * l * act_bytes_layer     # fwd + remat + bwd
    logits_traffic = 3 * t * v * 4                 # fwd write, bwd read/write (f32)
    hbm = param_traffic + grad_traffic + opt_traffic + act_traffic + logits_traffic

    # ---- collective link-bytes (global, per step)
    fsdp_ag = 2 * mb * (dp - 1) * (l * (attn_p + ffn_stored) * pb)
    grad_ar = 2 * (dp - 1) * p_stored * 4
    act_z = t_mb * d * 2
    tp_ar = 3 * mb * l * 2 * 2 * (tp - 1) * act_z // max(tp, 1)  # 2 AR/layer, fwd+bwd+remat
    moe_a2a = 0
    if cfg.is_moe:
        # dispatch+combine x (fwd+bwd+remat): ~top_k*T*D crossing EP axis
        moe_a2a = 3 * 2 * l * cfg.top_k * t * d * 2
    coll = fsdp_ag + grad_ar + tp_ar + moe_a2a
    return dict(flops=float(flops), hbm_bytes=float(hbm),
                coll_bytes=float(coll))


def lm_prefill_cost(cfg, shape, mesh):
    b, s = shape["global_batch"], shape["seq_len"]
    t = b * s
    dp = dp_size(mesh)
    tp = mesh.shape["model"]
    attn_p, ffn_act, ffn_stored = _lm_dims(cfg)
    l, d, v = cfg.n_layers, cfg.d_model, cfg.vocab
    s_vis = _s_vis(cfg, s)

    flops = 2 * (l * (attn_p + ffn_act)) * t + 2 * (d * v) * b \
        + l * _attn_flops_per_layer(cfg, 1, s, s_vis) * b
    param_traffic = l * (attn_p + ffn_stored) * 2
    act_traffic = l * t * (6 * d + (cfg.n_heads + 2 * cfg.n_kv_heads)
                           * cfg.head_dim + 2 * (ffn_act // d)) * 2
    cache_traffic = l * b * 2 * cfg.n_kv_heads * s * cfg.head_dim * 2
    hbm = param_traffic + act_traffic + cache_traffic

    fsdp_ag = (dp - 1) * param_traffic
    act_z = t * d * 2
    tp_ar = l * 2 * 2 * (tp - 1) * act_z // max(tp, 1)
    moe_a2a = 2 * l * cfg.top_k * t * d * 2 if cfg.is_moe else 0
    coll = fsdp_ag + tp_ar + moe_a2a
    return dict(flops=float(flops), hbm_bytes=float(hbm),
                coll_bytes=float(coll))


def lm_decode_cost(cfg, shape, mesh):
    b, s = shape["global_batch"], shape["seq_len"]
    dp = dp_size(mesh)
    tp = mesh.shape["model"]
    attn_p, ffn_act, ffn_stored = _lm_dims(cfg)
    l, d, v = cfg.n_layers, cfg.d_model, cfg.vocab
    s_vis = _s_vis(cfg, s, k_chunk=0) if cfg.attn_type != "full" else s

    flops = 2 * (l * (attn_p + ffn_act)) * b + 2 * (d * v) * b \
        + l * 2 * 2 * b * cfg.n_heads * cfg.head_dim * s_vis
    param_traffic = l * (attn_p + ffn_stored) * 2 + d * v * 2
    cache_read = l * b * 2 * cfg.n_kv_heads * s_vis * cfg.head_dim * 2
    cache_write = l * b * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    hbm = param_traffic + cache_read + cache_write + b * v * 4

    fsdp_ag = (dp - 1) * param_traffic  # weight gather dominates decode comms
    act_z = b * d * 2
    tp_ar = l * 2 * 2 * (tp - 1) * act_z // max(tp, 1)
    moe_a2a = 2 * l * cfg.top_k * b * d * 2 if cfg.is_moe else 0
    coll = fsdp_ag + tp_ar + moe_a2a
    return dict(flops=float(flops), hbm_bytes=float(hbm),
                coll_bytes=float(coll))


def lm_cost(kind: str, cfg, shape, mesh):
    return {"train": lm_train_cost, "prefill": lm_prefill_cost,
            "decode": lm_decode_cost}[kind](cfg, shape, mesh)

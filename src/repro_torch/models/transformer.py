"""Decoder-only transformer backbone covering the five assigned LM archs —
the port of ``repro/models/transformer.py``:

  nemotron-4-340b  GQA kv8, squared-ReLU FFN
  gemma2-2b        GQA kv4, alternating local(4096)/global attn, softcaps
  granite-3-8b     GQA kv8, SwiGLU
  mixtral-8x7b     GQA kv8, SWA(4096), MoE 8e top-2
  kimi-k2-1t-a32b  GQA kv8, MoE 384e top-8 (+1 shared), SwiGLU

Plain functions on the reference's param tree: layers stacked [L, ...]
under ``params["layers"]``, applied one after another (the reference's
``lax.scan``), each layer under ``torch.utils.checkpoint`` when gradients
are taken (the reference's ``jax.checkpoint(nothing_saveable)``: the
backward re-runs each layer's forward, which the cost model's 8NT
counts).  Train steps use gradient (micro-batch) accumulation in float32.

The reference's sharding constraints (``act_constraint``,
``mb_constraint``, ...) do nothing on one device and are left out.

Three departures from the reference's code, none from its values:
  * ``local_global`` layers run only the branch they select; the
    reference traces both under ``scan`` and keeps one with ``where``;
  * ``decode_step`` attends grouped ([B, G, rep, ...]) instead of
    repeating the cache to the full head count (at 32k tokens the repeated
    cache of one global layer is GBs), and writes the new token's keys and
    values into ``cache`` in place and returns it: the reference returns
    an updated copy, which under ``jit`` with donation is the same buffer;
  * ``init_params`` draws from a ``torch.Generator`` seeded by ``seed``
    (not ``jax.random``'s numbers: to share a state with the reference,
    load it with ``repro_torch.convert``), each leaf in place in
    ``cfg.dtype``, so no float32 copy of a FULL table is made.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.train_step import value_and_grad
from repro_torch.device import resolve_device
from repro_torch.models.attention import NEG_INF, flash_attention
from repro_torch.models.moe import moe_ffn
from repro_torch.optim.optimizers import tree_map

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    activation: str = "swiglu"            # swiglu | squared_relu | gelu
    attn_type: str = "full"               # full | swa | local_global
    window: int = 4096
    attn_softcap: float | None = None     # gemma2: 50.0
    final_softcap: float | None = None    # gemma2: 30.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_experts: int = 0
    capacity_factor: float = 1.25
    # numerics / training
    dtype: str = "bfloat16"
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.is_moe:
            fmoe = self.moe_d_ff
            n_mats = 3 if self.activation == "swiglu" else 2
            ffn = (self.n_experts + self.shared_experts) * n_mats * d * fmoe \
                + d * self.n_experts
        else:
            n_mats = 3 if self.activation == "swiglu" else 2
            ffn = n_mats * d * f
        return self.n_layers * (attn + ffn + 2 * d) + 2 * v * d + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        n_mats = 3 if self.activation == "swiglu" else 2
        ffn = (self.top_k + self.shared_experts) * n_mats * d * self.moe_d_ff \
            + d * self.n_experts
        return self.n_layers * (attn + ffn + 2 * d) + 2 * self.vocab * d + d


# ----------------------------------------------------------------- params

def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> dict:
    """N(0, 0.02²) weights (the router in float32) and unit norms, the
    reference's tree and shapes, drawn in place in ``cfg.dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = DTYPES[cfg.dtype]
    d, dh = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    l = cfg.n_layers

    def norm(*shape):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            0.0, 0.02, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers = {"attn_norm": ones(l, d), "ffn_norm": ones(l, d),
              "wq": norm(l, d, h * dh), "wk": norm(l, d, kv * dh),
              "wv": norm(l, d, kv * dh), "wo": norm(l, h * dh, d)}
    if cfg.is_moe:
        e, f = cfg.n_experts, cfg.moe_d_ff
        layers["router"] = norm(l, d, e).to(torch.float32)
        layers["w_up"] = norm(l, e, d, f)
        layers["w_down"] = norm(l, e, f, d)
        if cfg.activation == "swiglu":
            layers["w_gate"] = norm(l, e, d, f)
        if cfg.shared_experts:
            layers["ws_up"] = norm(l, d, cfg.shared_experts * f)
            layers["ws_down"] = norm(l, cfg.shared_experts * f, d)
    else:
        f = cfg.d_ff
        layers["w_up"] = norm(l, d, f)
        layers["w_down"] = norm(l, f, d)
        if cfg.activation == "swiglu":
            layers["w_gate"] = norm(l, d, f)
    return {"embed": norm(cfg.vocab, d), "layers": layers,
            "final_norm": ones(d), "lm_head": norm(d, cfg.vocab)}


def _layers(params) -> list[dict]:
    """The stacked [L, ...] layer tree as L per-layer dicts of views.
    ``unbind`` gives the backward one node that stacks the L slices' grads
    (indexing each layer would give each a full-size zero-filled grad)."""
    names = list(params["layers"])
    per = zip(*(params["layers"][n].unbind(0) for n in names))
    return [dict(zip(names, ws)) for ws in per]


def _layer_is_local(cfg: TransformerConfig) -> list[bool]:
    if cfg.attn_type == "swa":
        return [True] * cfg.n_layers
    if cfg.attn_type == "local_global":
        return [i % 2 == 0 for i in range(cfg.n_layers)]
    return [False] * cfg.n_layers


# ----------------------------------------------------------------- pieces

def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device: dividing by it is a
    true division (torch multiplies by the reciprocal of a Python scalar).
    Filled there, not copied from the host: ``torch.tensor(x,
    device="cuda")`` copies from pageable memory and waits for the
    stream, thousands of times a step."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def rmsnorm(x, w, eps=1e-6):
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def rope(x, positions, theta):
    """x [..., S, H, dh]; positions [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) \
        / _f32(half, x)
    freqs = torch.pow(theta, exps)
    ang = positions[..., None].to(torch.float32) * freqs     # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def _ffn_act(cfg, x, w):
    if cfg.activation == "swiglu":
        up = x @ w["w_up"]
        gate = F.silu((x @ w["w_gate"]).to(torch.float32)).to(x.dtype)
        return (up * gate) @ w["w_down"]
    if cfg.activation == "squared_relu":
        h = torch.relu(x @ w["w_up"])
        return (h * h) @ w["w_down"]
    # jax.nn.gelu is the tanh form
    h = F.gelu((x @ w["w_up"]).to(torch.float32),
               approximate="tanh").to(x.dtype)
    return h @ w["w_down"]


def _softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / _f32(cap, x))


def attention(cfg: TransformerConfig, x, w, positions, *, is_local,
              kv_cache=None, cache_pos=None):
    """x [B, S, D].  Training/prefill when kv_cache is None; decode
    (S == 1) when kv_cache = (k [B, Hkv, Sc, dh], v) and cache_pos is the
    (scalar) position.  Returns (out, cache): prefill's (k, v) [B, S, Hkv,
    dh]; decode's cache, written in place."""
    b, s, d = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ w["wq"]).reshape(b, s, h, dh)
    k = (x @ w["wk"]).reshape(b, s, kvh, dh)
    v = (x @ w["wv"]).reshape(b, s, kvh, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = dh ** -0.5
    rep = h // kvh

    if kv_cache is None:
        # causal (optionally banded, compute-skipped) flash attention
        out = flash_attention(q, k, v, causal=True,
                              window=cfg.window if is_local else None,
                              softcap=cfg.attn_softcap,
                              q_chunk=min(512, s), k_chunk=min(1024, s))
        return out.reshape(b, s, h * dh) @ w["wo"], (k, v)

    # decode: write into the cache (the start clamped so the update fits,
    # as dynamic_update_slice clamps), attend over the (windowed) cache
    ck, cv = kv_cache
    sc = ck.shape[2]
    pos = int(cache_pos)
    at = min(max(pos, 0), sc - s)
    ck[:, :, at:at + s] = k.transpose(1, 2)
    cv[:, :, at:at + s] = v.transpose(1, 2)
    if is_local and cfg.window < sc:
        wdw = cfg.window
        start = min(max(pos - wdw + 1, 0), sc - wdw)
        ks_, vs_ = ck[:, :, start:start + wdw], cv[:, :, start:start + wdw]
        kidx = start + torch.arange(wdw, device=x.device)
    else:
        ks_, vs_ = ck, cv
        kidx = torch.arange(sc, device=x.device)
    # grouped: query head g*rep + r reads kv head g, as jnp.repeat's; rows
    # (r, s) of each [B, G] matmul, against the cache as it lies
    qg = q.reshape(b, s, kvh, rep, dh).permute(0, 2, 3, 1, 4) \
        .reshape(b, kvh, rep * s, dh)
    logits = torch.matmul(qg, ks_.transpose(-1, -2)).to(torch.float32) \
        * scale
    logits = _softcap(logits, cfg.attn_softcap)
    logits = torch.where(kidx <= pos, logits, NEG_INF)
    p = torch.softmax(logits, -1).to(x.dtype)
    out = torch.matmul(p, vs_).reshape(b, kvh, rep, s, dh) \
        .permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h * dh) @ w["wo"], (ck, cv)


def _block(cfg, x, w, positions, is_local, kv_cache=None, cache_pos=None):
    a, new_cache = attention(cfg, rmsnorm(x, w["attn_norm"]), w, positions,
                             is_local=is_local, kv_cache=kv_cache,
                             cache_pos=cache_pos)
    x = x + a
    hnorm = rmsnorm(x, w["ffn_norm"])
    if cfg.is_moe:
        f = moe_ffn(cfg, hnorm, w)
    else:
        f = _ffn_act(cfg, hnorm, w)
    return x + f, new_cache


def _block_out(cfg, x, w, positions, is_local):
    return _block(cfg, x, w, positions, is_local)[0]


# ----------------------------------------------------------------- forward

def _positions(tokens) -> torch.Tensor:
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def forward(cfg: TransformerConfig, params, tokens):
    """tokens [B, S] -> logits [B, S, V] (matmuls in the params' dtype,
    float32 softcap)."""
    x = params["embed"][tokens]
    positions = _positions(tokens)
    for w, is_local in zip(_layers(params), _layer_is_local(cfg)):
        if torch.is_grad_enabled():
            x = checkpoint(_block_out, cfg, x, w, positions, is_local,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_out(cfg, x, w, positions, is_local)
    x = rmsnorm(x, params["final_norm"])
    logits = x @ params["lm_head"]
    return _softcap(logits.to(torch.float32), cfg.final_softcap)


def lm_loss(cfg: TransformerConfig, params, tokens, labels):
    logits = forward(cfg, params, tokens)
    # logsumexp-form CE: no second [.., V] log-prob buffer
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0] - lse
    return -torch.mean(ll)


def train_step(cfg: TransformerConfig, opt, params, opt_state, tokens,
               labels, n_microbatches: int = 1,
               grad_dtype=torch.float32):
    """Gradient-accumulated train step (tokens [B, S]): microbatches are
    contiguous rows; their gradients are summed in ``grad_dtype`` and
    divided by ``n_microbatches``.  Returns (params, opt_state, loss)."""
    def loss_fn(p, t, l):
        return lm_loss(cfg, p, t, l)

    if n_microbatches == 1:
        loss, grads = value_and_grad(lambda p: loss_fn(p, tokens, labels),
                                     params)
    else:
        mb = tokens.shape[0] // n_microbatches
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=grad_dtype,
                                               device=p.device), params)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(n_microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            l_i, g = value_and_grad(
                lambda p: loss_fn(p, tokens[rows], labels[rows]), params)
            tree_map(lambda a, b: a.add_(b.to(grad_dtype)), grads, g)
            loss = loss + l_i
            del g
        n = _f32(n_microbatches, tokens)
        tree_map(lambda a: a.div_(n.to(a.dtype)), grads)
        loss = loss / n
    new_params, new_opt = opt.update(grads, opt_state, params)
    return new_params, new_opt, loss


# ----------------------------------------------------------------- serving

def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  device="cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    dt = DTYPES[cfg.dtype]
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefill(cfg: TransformerConfig, params, tokens):
    """tokens [B, S] -> (logits [B, V] for the last position, kv cache
    {'k', 'v'} [L, B, Hkv, S, dh])."""
    x = params["embed"][tokens]
    positions = _positions(tokens)
    ks = vs = None
    for i, (w, is_local) in enumerate(zip(_layers(params),
                                          _layer_is_local(cfg))):
        x, (k, v) = _block(cfg, x, w, positions, is_local)
        if ks is None:
            shape = (cfg.n_layers,) + k.transpose(1, 2).shape
            ks = torch.empty(shape, dtype=k.dtype, device=k.device)
            vs = torch.empty(shape, dtype=v.dtype, device=v.device)
        ks[i] = k.transpose(1, 2)
        vs[i] = v.transpose(1, 2)
    x = rmsnorm(x[:, -1], params["final_norm"])
    logits = _softcap((x @ params["lm_head"]).to(torch.float32),
                      cfg.final_softcap)
    return logits, {"k": ks, "v": vs}


def decode_step(cfg: TransformerConfig, params, token, cache, cache_pos):
    """token [B, 1]; cache {'k', 'v'} [L, B, Hkv, S, dh]; cache_pos the
    position (same across the batch).  Returns (logits [B, V], cache),
    the cache written in place."""
    x = params["embed"][token]
    positions = torch.full((1, 1), int(cache_pos), dtype=torch.int32,
                           device=token.device)
    for i, (w, is_local) in enumerate(zip(_layers(params),
                                          _layer_is_local(cfg))):
        x, _ = _block(cfg, x, w, positions, is_local,
                      kv_cache=(cache["k"][i], cache["v"][i]),
                      cache_pos=cache_pos)
    x = rmsnorm(x[:, -1], params["final_norm"])
    logits = _softcap((x @ params["lm_head"]).to(torch.float32),
                      cfg.final_softcap)
    return logits, cache

"""The CTR and sequential model pool on the shared embedding substrate —
the port of ``repro/models/recsys_models.py``.

  deepfm    (arXiv:1703.04247): FM interaction ∥ deep MLP 400-400-400
  xdeepfm   (arXiv:1803.05170): CIN 200-200-200 ∥ MLP 400-400
  bert4rec  (arXiv:1904.06690): bidirectional transformer over item seqs
  dlrm-rm2  (arXiv:1906.00091): bottom MLP + 26 tables + dot interaction

Tables are stacked [F, V, D]; a lookup gathers one row per field
(single-hot fields).  ``dlrm_retrieve`` scores candidates by swapping the
item field and reusing the fixed user-side compute — a batched dot, not a
loop.  Plain functions on param dicts, as the reference's; every
interaction, MLP and attention is a matmul or an einsum, outside any
kernel, as the reference's are outside any ``pallas_call``.

Every ``*_init`` draws from a ``torch.Generator`` seeded by ``seed`` on
``device`` (not ``jax.random``'s numbers: to share a state with the
reference, load it with ``repro_torch.convert``), and draws each leaf in
place, so a FULL-size table (DLRM-RM2's is 69.8 GB) is allocated once.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

# candidates scored per pass of ``dlrm_retrieve``: bounds its working set
# ([C, F + 1, D] interaction inputs, ~0.9 GB at DLRM-RM2's widths) whatever
# the candidate count
RETRIEVE_CHUNK = 1 << 17


# ----------------------------------------------------------------- common

def _normal(gen: torch.Generator, shape, std: float, dev) -> torch.Tensor:
    """N(0, std²) drawn in place: no second tensor of ``shape``."""
    return torch.empty(shape, dtype=torch.float32,
                       device=dev).normal_(0.0, std, generator=gen)


def _init_rng(seed: int, device):
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(int(seed)), dev


def _mlp_params(gen: torch.Generator, dims, dev) -> list:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases."""
    return [{"w": _normal(gen, (dims[i], dims[i + 1]),
                          math.sqrt(2.0 / dims[i]), dev),
             "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=dev)}
            for i in range(len(dims) - 1)]


def _mlp(params, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, l in enumerate(params):
        x = x @ l["w"] + l["b"]
        if i + 1 < len(params) or final_act:
            x = torch.relu(x)
    return x


def lookup_fields(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables [F, V, D] (or [F, V]); ids [B, F] single-hot -> [B, F, D]
    (or [B, F]): row ids[b, f] of table f, by advanced indexing."""
    fields = torch.arange(tables.shape[0], device=ids.device)
    return tables[fields[None, :], ids.long()]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, by the reference's formula:
    max(x, 0) - x·y + log1p(exp(-|x|))."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ----------------------------------------------------------------- deepfm

@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab: int = 1_000_000
    mlp_dims: tuple = (400, 400, 400)


def deepfm_init(cfg: DeepFMConfig, seed: int = 0, device="cuda") -> dict:
    gen, dev = _init_rng(seed, device)
    return {
        "tables": _normal(gen, (cfg.n_sparse, cfg.vocab, cfg.embed_dim),
                          0.01, dev),
        "linear": _normal(gen, (cfg.n_sparse, cfg.vocab), 0.01, dev),
        "mlp": _mlp_params(gen, (cfg.n_sparse * cfg.embed_dim,)
                           + tuple(cfg.mlp_dims) + (1,), dev),
        "bias": torch.zeros((), dtype=torch.float32, device=dev),
    }


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb [B, F, D] -> [B] second-order FM term:
    0.5 * ((Σ_f v_f)^2 − Σ_f v_f^2) summed over D."""
    s = emb.sum(1)
    s2 = (emb * emb).sum(1)
    return 0.5 * (s * s - s2).sum(-1)


def deepfm_forward(cfg: DeepFMConfig, params, ids) -> torch.Tensor:
    emb = lookup_fields(params["tables"], ids)                       # [B,F,D]
    first = lookup_fields(params["linear"], ids).sum(-1)             # [B]
    fm = fm_interaction(emb)
    deep = _mlp(params["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
    return first + fm + deep + params["bias"]


# ----------------------------------------------------------------- xdeepfm

@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab: int = 1_000_000
    cin_layers: tuple = (200, 200, 200)
    mlp_dims: tuple = (400, 400)


def xdeepfm_init(cfg: XDeepFMConfig, seed: int = 0, device="cuda") -> dict:
    gen, dev = _init_rng(seed, device)
    params = {
        "tables": _normal(gen, (cfg.n_sparse, cfg.vocab, cfg.embed_dim),
                          0.01, dev),
        "linear": _normal(gen, (cfg.n_sparse, cfg.vocab), 0.01, dev),
        "mlp": _mlp_params(gen, (cfg.n_sparse * cfg.embed_dim,)
                           + tuple(cfg.mlp_dims) + (1,), dev),
    }
    cin_w = []
    h_prev = cfg.n_sparse
    for h in cfg.cin_layers:
        cin_w.append(_normal(gen, (h, h_prev, cfg.n_sparse),
                             math.sqrt(2.0 / (h_prev * cfg.n_sparse)), dev))
        h_prev = h
    params["cin"] = cin_w
    params["cin_out"] = _normal(gen, (sum(cfg.cin_layers), 1), 0.1, dev)
    params["bias"] = torch.zeros((), dtype=torch.float32, device=dev)
    return params


def cin(params_cin, x0: torch.Tensor) -> torch.Tensor:
    """Compressed Interaction Network.  x0 [B, F, D]; each weight is
    [H_k, H_{k-1}, F]; returns the per-layer sums over D, [B, Σ H_k]."""
    xk = x0
    outs = []
    for w in params_cin:
        # z [B, Hk, F, D] = outer product along field axes
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)
        xk = torch.einsum("bhmd,nhm->bnd", z, w)                    # [B, H, D]
        outs.append(xk.sum(-1))                                     # [B, H]
    return torch.cat(outs, -1)


def xdeepfm_forward(cfg: XDeepFMConfig, params, ids) -> torch.Tensor:
    emb = lookup_fields(params["tables"], ids)
    first = lookup_fields(params["linear"], ids).sum(-1)
    p = cin(params["cin"], emb) @ params["cin_out"]
    deep = _mlp(params["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
    return first + p[:, 0] + deep + params["bias"]


# ----------------------------------------------------------------- bert4rec

@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_items: int = 1_000_000
    d_ff: int = 256


def bert4rec_init(cfg: BERT4RecConfig, seed: int = 0, device="cuda") -> dict:
    gen, dev = _init_rng(seed, device)
    d = cfg.embed_dim
    s = 1.0 / math.sqrt(d)
    params = {"item_embed": _normal(gen, (cfg.n_items, d), 0.02, dev),
              "pos_embed": _normal(gen, (cfg.seq_len, d), 0.02, dev)}
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "wq": _normal(gen, (d, d), s, dev),
            "wk": _normal(gen, (d, d), s, dev),
            "wv": _normal(gen, (d, d), s, dev),
            "wo": _normal(gen, (d, d), s, dev),
            "w1": _normal(gen, (d, cfg.d_ff), s, dev),
            "w2": _normal(gen, (cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff), dev),
            "ln1": torch.ones((d,), dtype=torch.float32, device=dev),
            "ln2": torch.ones((d,), dtype=torch.float32, device=dev),
        })
    params["blocks"] = blocks
    params["out_bias"] = torch.zeros((cfg.n_items,), dtype=torch.float32,
                                     device=dev)
    return params


def _ln(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Layer norm without bias, as the reference's: (x - μ)·rsqrt(σ² + ε)·w."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w


def bert4rec_encode(cfg: BERT4RecConfig, params, item_seq, seq_mask
                    ) -> torch.Tensor:
    """item_seq [B, S] -> hidden [B, S, D] (bidirectional: no causal mask).
    Padded keys (``seq_mask`` False) get the logit -1e30, as the
    reference's; the logits are divided by sqrt(d / h) as a float32 tensor
    (torch would multiply by the reciprocal of a Python scalar); GELU is
    the tanh form, ``jax.nn.gelu``'s default."""
    b, s = item_seq.shape
    d, h = cfg.embed_dim, cfg.n_heads
    x = params["item_embed"][item_seq.long()] + params["pos_embed"][None, :s]
    attn_mask = seq_mask[:, None, None, :]  # key-side padding mask
    temp = torch.full((), math.sqrt(d / h), dtype=torch.float32,
                      device=x.device)
    for blk in params["blocks"]:
        y = _ln(x, blk["ln1"])
        q = (y @ blk["wq"]).reshape(b, s, h, d // h)
        k = (y @ blk["wk"]).reshape(b, s, h, d // h)
        v = (y @ blk["wv"]).reshape(b, s, h, d // h)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / temp
        logits = torch.where(attn_mask, logits, -1e30)
        p = torch.softmax(logits, -1)
        a = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d)
        x = x + a @ blk["wo"]
        y = _ln(x, blk["ln2"])
        x = x + F.gelu(y @ blk["w1"], approximate="tanh") @ blk["w2"]
    return x


def bert4rec_loss(cfg: BERT4RecConfig, params, item_seq, seq_mask, labels,
                  label_mask) -> torch.Tensor:
    """Cloze objective: predict masked items (tied output embedding)."""
    hid = bert4rec_encode(cfg, params, item_seq, seq_mask)
    logits = hid @ params["item_embed"].T + params["out_bias"]
    logp = torch.log_softmax(logits, -1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -torch.sum(ll * label_mask) / label_mask.sum().clamp_min(1.0)


def bert4rec_sampled_loss(cfg: BERT4RecConfig, params, item_seq, seq_mask,
                          mask_pos, labels, neg_ids) -> torch.Tensor:
    """Cloze objective with sampled softmax (full-vocab logits at
    65536x200 positions x 1M items would be ~50 TB — see configs).
    mask_pos [B, M]: masked positions; labels [B, M]: true items;
    neg_ids [B, M, N]: sampled negatives."""
    hid = bert4rec_encode(cfg, params, item_seq, seq_mask)
    pos = mask_pos.long()[..., None].expand(-1, -1, hid.shape[-1])
    h = hid.gather(1, pos)                                          # [B,M,D]
    cand = torch.cat([labels.long()[..., None], neg_ids.long()], -1)
    ce = params["item_embed"][cand]                                 # [B,M,1+N,D]
    logits = torch.einsum("bmd,bmnd->bmn", h, ce) + params["out_bias"][cand]
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(logp[..., 0])


def bert4rec_serve(cfg: BERT4RecConfig, params, item_seq, seq_mask,
                   slate_ids):
    """Online/bulk serving: user representation + re-ranking slate scores
    (catalogue-wide scoring is the retrieval cell's job)."""
    hid = bert4rec_encode(cfg, params, item_seq, seq_mask)
    u = hid[:, -1]                                                  # [B, D]
    cand = params["item_embed"][slate_ids.long()]                   # [B,K,D]
    scores = torch.einsum("bd,bkd->bk", u, cand)
    return u, scores


def bert4rec_retrieve(cfg: BERT4RecConfig, params, item_seq, seq_mask,
                      cand_ids) -> torch.Tensor:
    """Score the last position against candidate items (batched dot)."""
    hid = bert4rec_encode(cfg, params, item_seq, seq_mask)
    u = hid[:, -1]                                     # [B, D]
    cand = params["item_embed"][cand_ids.long()]       # [C, D]
    return u @ cand.T                                  # [B, C]


# ----------------------------------------------------------------- dlrm

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab: int = 10_000_000
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)


def dlrm_init(cfg: DLRMConfig, seed: int = 0, device="cuda") -> dict:
    gen, dev = _init_rng(seed, device)
    f = cfg.n_sparse + 1
    top_in = cfg.bot_mlp[-1] + f * (f - 1) // 2
    return {
        "tables": _normal(gen, (cfg.n_sparse, cfg.vocab, cfg.embed_dim),
                          0.01, dev),
        "bot": _mlp_params(gen, (cfg.n_dense,) + tuple(cfg.bot_mlp), dev),
        "top": _mlp_params(gen, (top_in,) + tuple(cfg.top_mlp), dev),
    }


def dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """vecs [B, F, D] -> strictly-lower-triangular pairwise dots
    [B, F(F-1)/2], in row-major pair order (1,0), (2,0), (2,1), ..."""
    f = vecs.shape[1]
    z = torch.bmm(vecs, vecs.transpose(1, 2))
    iu, ju = torch.tril_indices(f, f, -1, device=vecs.device)
    return z[:, iu, ju]


def dlrm_forward_from_emb(cfg: DLRMConfig, params, dense, emb
                          ) -> torch.Tensor:
    """Forward given pre-gathered embeddings [B, F, D] — the grad entry
    point for lazy/row-wise table optimizers."""
    bot = _mlp(params["bot"], dense, final_act=True)                 # [B, 64]
    vecs = torch.cat([bot[:, None], emb], 1)                         # [B,27,64]
    inter = dot_interaction(vecs)
    top_in = torch.cat([bot, inter], -1)
    return _mlp(params["top"], top_in)[:, 0]


def dlrm_forward(cfg: DLRMConfig, params, dense, ids) -> torch.Tensor:
    emb = lookup_fields(params["tables"], ids)                       # [B,26,64]
    return dlrm_forward_from_emb(cfg, params, dense, emb)


@torch.no_grad()
def rowwise_adagrad_update(tables: torch.Tensor, acc: torch.Tensor, ids,
                           g_emb: torch.Tensor, lr: float = 0.01,
                           eps: float = 1e-8):
    """Lazy row-wise AdaGrad (the production DLRM optimizer): only the
    B*F touched rows are read and updated, and the accumulator is one
    scalar per ROW ([F, V] instead of [F, V, D]) — vs dense Adam, which
    streams the entire [F, V, D] table plus two moments every step.

    tables [F, V, D]; acc [F, V]; ids [B, F]; g_emb [B, F, D].  Updates
    ``tables`` and ``acc`` IN PLACE and returns them: at DLRM-RM2 FULL
    the tables are 69.8 GB, and a functional copy of them a step is the
    very cost this optimizer exists to avoid.  As the reference's: every
    duplicate id's mean squared gradient goes into ``acc`` first, then
    each update reads its row's accumulated value (one ``index_add_`` of
    [F·V] over ``f·V + id`` offsets for each of the two)."""
    f, v, d = tables.shape
    rows = (ids.long() + torch.arange(f, device=ids.device)[None, :] * v
            ).reshape(-1)                                            # [B*F]
    g = g_emb.reshape(-1, d).to(torch.float32)
    acc_rows = acc.view(-1)
    acc_rows.index_add_(0, rows, (g * g).mean(-1))
    scale = torch.rsqrt(acc_rows.index_select(0, rows) + eps)
    tables.view(-1, d).index_add_(
        0, rows, (-lr * scale[:, None] * g).to(tables.dtype))
    return tables, acc


@torch.no_grad()
def dlrm_retrieve(cfg: DLRMConfig, params, dense, ids, cand_ids
                  ) -> torch.Tensor:
    """1 user x C candidates: user-side compute once, swap field 0 (vecs
    column 1).  dense [1, 13]; ids [1, 26]; cand_ids [C].  The candidates
    go through the interaction and top MLP ``RETRIEVE_CHUNK`` at a time."""
    bot = _mlp(params["bot"], dense, final_act=True)                 # [1, 64]
    emb = lookup_fields(params["tables"], ids)                       # [1,26,64]
    vecs = torch.cat([bot[:, None], emb], 1)                         # [1,27,64]
    outs = []
    for lo in range(0, cand_ids.shape[0], RETRIEVE_CHUNK):
        cand = params["tables"][0][cand_ids[lo:lo + RETRIEVE_CHUNK].long()]
        c = cand.shape[0]
        v = vecs.expand(c, -1, -1).clone()
        v[:, 1] = cand                                               # swap item field
        inter = dot_interaction(v)
        top_in = torch.cat([bot.expand(c, -1), inter], -1)
        outs.append(_mlp(params["top"], top_in)[:, 0])
    if not outs:
        return torch.zeros((0,), dtype=torch.float32, device=dense.device)
    return torch.cat(outs)

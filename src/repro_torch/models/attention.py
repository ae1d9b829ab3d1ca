"""Memory-bounded attention: online softmax over K/V chunks (flash-style)
— the port of ``repro/models/attention.py``, which is plain JAX and
reaches no ``pallas_call``; so is this, plain PyTorch.

Why it exists: a 32k prefill with materialised [B, H, S, S] scores is
~50 GiB on the 340B config; the tile loop caps the transient at a tile.

The reference's algebra, kept:
  * GQA grouped ([B, G, rep, ...]): keys and values are never repeated to
    the full head count;
  * online softmax per (q-chunk x k-chunk) tile, the softcap before the
    mask, masked scores at ``NEG_INF = -1e30`` (not -inf: a tile whose
    keys are all masked sets p = exp(0) = 1, which a later tile's
    correction exp(-1e30 - m) = 0 wipes; with -inf that would be NaN),
    the output ``acc / max(l, 1e-20)``, p and acc in the value dtype;
  * queries aligned to the end of the keys (``qpos = kv_offset + (sk -
    sq) + i``); pad keys masked through an int32-max position;
  * banded windows are compute-skipped: a q-chunk visits only
    ``min(nk, window // k_chunk + 2)`` k-chunks from
    ``clip(q_hi_chunk - (n_vis - 1), 0, nk - n_vis)``, so local/SWA
    layers cost O(S·W), which the cost model (``launch/analytic.py``)
    counts.

Where the reference ``vmap``s over q-chunks and ``fori_loop``s over
k-chunks, this batches the q-chunks and loops over the k-chunks in
Python: each step is one batched matmul for the scores and one for P·V
over every q-chunk of a group.  Rows are laid out (q-chunk, rep,
position) so that the full path's step is a plain [B, G] batch of
matmuls against the shared k-chunk, and the banded path's a [B, G,
q-chunk] batch against each q-chunk's own k-chunk.  A group holds
1/GROUPS of the q-chunks (at least a k-chunk's worth) and keeps one
step's float32 scores under TILE_BYTES (at 32k tokens and 32 heads all
q-chunks at once would be 4.3 GB a step).

One departure, exact: on the full causal path a group stops at the
k-chunk holding its last query's position.  The k-chunks after it are
masked for every row of the group, and each row has already seen key 0
(every query sees it when sk >= sq), so such a tile leaves (m, l, acc)
as they were, bit for bit (p = exp(-1e30 - m) = 0, corr = 1).  At 32k
tokens this skips ~44 % of a full layer's tiles; the cost model
(``launch/analytic.py``) counts full causal tiles, as the reference
computes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1
# float32 bytes of one tile step's scores: q-chunks run in groups under it
TILE_BYTES = 1 << 30
# a group holds 1/GROUPS of the q-chunks (a causal group stops at its
# last query's k-chunk)
GROUPS = 8


def _tile(q, kt, vt, qpos, kpos, scale, softcap, causal, window, carry):
    """One online-softmax update over a k-chunk for a group of rows.
    q [B, G, N, M, dh]; kt/vt [B, G, N, Kc, dh]; qpos [N, M]; kpos [N, Kc];
    carry = (m [B, G, N, M], l, acc [B, G, N, M, dh])."""
    m, l, acc = carry
    s = torch.matmul(q, kt.transpose(-1, -2)).to(torch.float32) * scale
    if softcap is not None:
        s = softcap * torch.tanh(
            s / torch.full((), softcap, dtype=torch.float32, device=s.device))
    mask = torch.ones((qpos.shape[0], qpos.shape[1], kpos.shape[1]),
                      dtype=torch.bool, device=s.device)
    if causal:
        mask &= kpos[:, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    pv = torch.matmul(p.to(vt.dtype), vt)
    acc_new = acc * corr[..., None].to(acc.dtype) + pv
    return m_new, l_new, acc_new


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    q_chunk=512, k_chunk=1024, kv_offset=0):
    """q [B, Sq, H, dh]; k/v [B, Sk, G, dh] with H = G*rep.
    kv_offset: global position of k[0] (for windowed caches).
    Returns [B, Sq, H, dh]."""
    b, sq, h, dh = q.shape
    sk, g = k.shape[1], k.shape[2]
    rep = h // g
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    nq = -(-sq // q_chunk)
    nk = -(-sk // k_chunk)
    sq_pad, sk_pad = nq * q_chunk, nk * k_chunk
    scale = dh ** -0.5
    dev = q.device

    # [B, G, nq, R, Qc, dh]
    qg = F.pad(q, (0, 0, 0, 0, 0, sq_pad - sq))
    qg = qg.reshape(b, nq, q_chunk, g, rep, dh).permute(0, 3, 1, 4, 2, 5)
    # [B, G, nk, Kc, dh]
    kp = F.pad(k, (0, 0, 0, 0, 0, sk_pad - sk)).permute(0, 2, 1, 3) \
        .reshape(b, g, nk, k_chunk, dh)
    vp = F.pad(v, (0, 0, 0, 0, 0, sk_pad - sk)).permute(0, 2, 1, 3) \
        .reshape(b, g, nk, k_chunk, dh)
    idx = torch.arange(sk_pad, device=dev)
    kpos_all = torch.where(idx < sk, kv_offset + idx,
                           INT32_MAX).reshape(nk, k_chunk)  # pad keys
    qpos_all = (kv_offset + (sk - sq)
                + torch.arange(sq_pad, device=dev)).reshape(nq, q_chunk)

    banded = window is not None and window < sk_pad
    n_vis = min(nk, window // k_chunk + 2) if banded else nk
    group = max(1, min(TILE_BYTES // (4 * b * h * q_chunk * k_chunk),
                       max(-(-nq // GROUPS), k_chunk // q_chunk)))
    skip = causal and not banded and sk >= sq
    outs = []
    for q0 in range(0, nq, group):
        qs = slice(q0, min(q0 + group, nq))
        n = qs.stop - qs.start
        qpos = qpos_all[qs][:, None, :].expand(n, rep, q_chunk) \
            .reshape(n, rep * q_chunk)
        if banded:
            # visit only the k-chunks intersecting [qpos0-window, qpos_end]
            qi = torch.arange(qs.start, qs.stop, device=dev)
            q_hi_chunk = torch.div(qi * q_chunk + (sk - sq) + q_chunk - 1,
                                   k_chunk, rounding_mode="floor")
            start = torch.clamp(q_hi_chunk - (n_vis - 1), 0, nk - n_vis)
            qc = qg[:, :, qs].reshape(b, g, n, rep * q_chunk, dh)
        else:
            qpos = qpos.reshape(1, n * rep * q_chunk)
            qc = qg[:, :, qs].reshape(b, g, 1, n * rep * q_chunk, dh)
        rows = qc.shape[2:4]
        m = torch.full((b, g) + rows, NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, g) + rows, dtype=torch.float32, device=dev)
        acc = torch.zeros((b, g) + rows + (dh,), dtype=v.dtype, device=dev)
        carry = (m, l, acc)
        n_steps = n_vis
        if skip:
            # the k-chunk of the group's last (pad) query is its last
            n_steps = min(nk, ((sk - sq) + qs.stop * q_chunk - 1) // k_chunk
                          + 1)
        for j in range(n_steps):
            if banded:
                kj = start + j
                kt, vt, kpos = kp[:, :, kj], vp[:, :, kj], kpos_all[kj]
            else:
                kt, vt = kp[:, :, j:j + 1], vp[:, :, j:j + 1]
                kpos = kpos_all[j:j + 1]
            carry = _tile(qc, kt, vt, qpos, kpos, scale, softcap, causal,
                          window, carry)
        _, l, acc = carry
        out = acc / torch.clamp(l, min=1e-20)[..., None].to(acc.dtype)
        outs.append(out.reshape(b, g, n, rep, q_chunk, dh))
    # [B, G, nq, R, Qc, dh] -> [B, Sq, H, dh]
    out = torch.cat(outs, 2) if len(outs) > 1 else outs[0]
    out = out.permute(0, 2, 4, 1, 3, 5).reshape(b, sq_pad, h, dh)
    return out[:, :sq]


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  kv_offset=0):
    """Dense oracle for tests (``repeat_interleave``, as ``jnp.repeat``:
    head i reads kv head i // rep)."""
    b, sq, h, dh = q.shape
    sk, g = k.shape[1], k.shape[2]
    rep = h // g
    kf = torch.repeat_interleave(k, rep, dim=2)
    vf = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf).to(torch.float32) \
        * dh ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(
            s / torch.full((), softcap, dtype=torch.float32, device=s.device))
    qpos = kv_offset + (sk - sq) + torch.arange(sq, device=q.device)
    kpos = kv_offset + torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, -1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf)

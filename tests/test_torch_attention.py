"""The port's chunked attention (``repro_torch.models.attention``) against
``repro.models.attention`` on the reference's own cases
(``tests/test_attention.py``): causal, banded (compute-skipped), softcap,
chunks that do not divide the sequence, and gradients against
``jax.grad``; plus queries that end short of the keys (a windowed cache's
``kv_offset``), the all-masked first tile of a banded row, bfloat16, and
q-chunk groups (``TILE_BYTES``).

Inputs are numpy-seeded and go to both packages.  Tolerances: the
reference's own for values, rtol 2e-4 / atol 2e-5 in float32; gradients
rtol 1e-4 / atol 1e-5; bfloat16 outputs within 2e-2 absolute (a few bf16
ulps of values below 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro_torch.models import attention as att
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def qkv(seed, b, sq, sk, h, g, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dh), (b, sk, g, dh), (b, sk, g, dh))]


def both(arrs, **kw):
    """(reference, port) flash_attention on the same numpy inputs."""
    ref = np.asarray(jatt.flash_attention(*map(jnp.asarray, arrs), **kw))
    got = att.flash_attention(*map(torch.from_numpy, arrs), **kw).numpy()
    return ref, got


@pytest.mark.parametrize("sq,h,g,dh", [(64, 4, 2, 16), (100, 8, 8, 8),
                                       (33, 4, 1, 32)])
def test_flash_matches_ref_causal(sq, h, g, dh):
    arrs = qkv(0, 2, sq, sq, h, g, dh)
    ref, got = both(arrs, causal=True, q_chunk=16, k_chunk=32)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    dense = att.attention_ref(*map(torch.from_numpy, arrs), causal=True)
    np.testing.assert_allclose(got, dense.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [8, 16, 64])
def test_flash_banded_matches_ref(window):
    arrs = qkv(1, 2, 96, 96, 4, 2, 16)
    ref, got = both(arrs, causal=True, window=window, q_chunk=16,
                    k_chunk=16)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    dense = att.attention_ref(*map(torch.from_numpy, arrs), causal=True,
                              window=window)
    np.testing.assert_allclose(got, dense.numpy(), rtol=RTOL, atol=ATOL)


def test_flash_softcap():
    arrs = qkv(2, 1, 40, 40, 2, 2, 16)
    ref, got = both(arrs, causal=True, softcap=50.0, q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_flash_nondivisible_chunks():
    arrs = qkv(3, 1, 37, 37, 2, 1, 8)
    ref, got = both(arrs, causal=True, q_chunk=16, k_chunk=16)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window,kv_offset", [(None, 0), (12, 0), (12, 40)])
def test_flash_queries_end_short_of_keys(window, kv_offset):
    """sq < sk: queries sit at the keys' end (``qpos = kv_offset + (sk -
    sq) + i``), the windowed cache's layout; pad keys are masked.  sk - sq
    is a multiple of k_chunk: the banded path's ``window // k_chunk + 2``
    chunks cover a window only where no q-chunk straddles a k-chunk
    boundary (in the reference too; the transformer's chunks never do)."""
    arrs = qkv(4, 2, 16, 45, 4, 2, 8)
    kw = dict(causal=True, window=window, kv_offset=kv_offset)
    ref, got = both(arrs, q_chunk=8, k_chunk=16, **kw)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    want = jatt.attention_ref(*map(jnp.asarray, arrs), **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_flash_straddling_band_follows_the_reference():
    """Where a q-chunk straddles a k-chunk boundary the reference's band
    misses keys of the window; the port visits the same chunks."""
    arrs = qkv(4, 2, 20, 45, 4, 2, 8)
    ref, got = both(arrs, causal=True, window=12, q_chunk=8, k_chunk=16)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_flash_all_masked_first_tile_stays_finite():
    """A banded row whose first visited k-chunk is wholly outside its
    window: p = exp(0) = 1 at NEG_INF, wiped by the next tile's
    correction (with -inf it would be NaN)."""
    arrs = qkv(5, 1, 64, 64, 2, 1, 8)
    ref, got = both(arrs, causal=True, window=3, q_chunk=16, k_chunk=4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_flash_q_chunk_groups(monkeypatch):
    """q-chunks run in groups under TILE_BYTES; several groups give the
    one group's values."""
    arrs = qkv(6, 2, 70, 70, 4, 2, 8)
    for kw in (dict(causal=True), dict(causal=True, window=20)):
        whole = att.flash_attention(*map(torch.from_numpy, arrs),
                                    q_chunk=8, k_chunk=16, **kw)
        monkeypatch.setattr(att, "TILE_BYTES", 4 * 2 * 4 * 8 * 16 * 2)
        grouped = att.flash_attention(*map(torch.from_numpy, arrs),
                                      q_chunk=8, k_chunk=16, **kw)
        monkeypatch.undo()
        np.testing.assert_allclose(grouped.numpy(), whole.numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sq,sk", [(96, 96), (40, 96), (37, 37)])
def test_flash_causal_skip_changes_no_value(monkeypatch, sq, sk):
    """The full causal path's groups stop at their last query's k-chunk;
    one group over all q-chunks visits every k-chunk: the same values."""
    arrs = qkv(11, 2, sq, sk, 4, 2, 8)
    kw = dict(causal=True, q_chunk=8, k_chunk=16)
    grouped = att.flash_attention(*map(torch.from_numpy, arrs), **kw)
    monkeypatch.setattr(att, "GROUPS", 1)
    whole = att.flash_attention(*map(torch.from_numpy, arrs), **kw)
    np.testing.assert_allclose(grouped.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)
    ref, _ = both(arrs, **kw)
    np.testing.assert_allclose(grouped.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_flash_bfloat16():
    """bfloat16 q/k/v: p and acc in bfloat16 as in the reference."""
    arrs = qkv(7, 1, 48, 48, 4, 2, 16)
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    ref = jatt.flash_attention(*jq, causal=True, window=16, softcap=50.0,
                               q_chunk=16, k_chunk=16)
    got = att.flash_attention(*[torch.from_numpy(a).to(torch.bfloat16)
                                for a in arrs], causal=True, window=16,
                              softcap=50.0, q_chunk=16, k_chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("window,softcap", [(None, None), (8, None),
                                            (None, 50.0)])
def test_flash_grads_match_jax(window, softcap):
    arrs = qkv(8, 1, 32, 32, 2, 1, 8)
    ct = np.random.default_rng(9).standard_normal(arrs[0].shape) \
        .astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap, q_chunk=8,
              k_chunk=8)

    def f(q, k, v):
        return jnp.sum(jatt.flash_attention(q, k, v, **kw) * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    (att.flash_attention(*ts, **kw) * torch.from_numpy(ct)).sum().backward()
    assert np.isfinite(ts[0].grad.numpy()).all()
    for w, t in zip(want, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (10, 30.0)])
def test_attention_ref_matches_reference(window, softcap):
    """``repeat_interleave`` is ``jnp.repeat`` (``.repeat`` would tile)."""
    arrs = qkv(10, 2, 24, 24, 6, 2, 8)
    kw = dict(causal=True, window=window, softcap=softcap)
    want = jatt.attention_ref(*map(jnp.asarray, arrs), **kw)
    got = att.attention_ref(*map(torch.from_numpy, arrs), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)

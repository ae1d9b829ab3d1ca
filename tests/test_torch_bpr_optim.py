"""The port's dense recall oracle (``core/bpr.py::recall_at_k``), the LR
ramp (``optim/optimizers.py::WarmupLinearLR``) and ``global_norm_clip``
against the reference's.

Tolerances: ``recall_at_k`` bitwise on both mask forms (integer-valued
embeddings, so both packages' ``user_e @ item_e.T`` are exact), with the
same ``DeprecationWarning`` and ``TypeError``; ``WarmupLinearLR`` bitwise
at every step; ``global_norm_clip`` within fp32 tolerance (rtol 1e-6 on
the norm, rtol 1e-6 / atol 1e-7 on the clipped leaves: the leaves' sums
run in another order).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpr as jbpr
from repro.optim import optimizers as jopt
from repro_torch.core import bpr
from repro_torch.optim import WarmupLinearLR, global_norm_clip
from repro_torch.optim.optimizers import tree_paths
from torch_threads import one_torch_thread  # noqa: F401


def _recall_case(seed, nu=30, ni=45, d=8, ne=150):
    rng = np.random.default_rng(seed)
    ue = rng.integers(-3, 4, (nu, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (ni, d)).astype(np.float32)
    user = rng.integers(0, nu, ne)
    item = rng.integers(0, ni, ne)
    test_pos = [rng.integers(0, ni, rng.integers(0, 5)) for _ in range(nu)]
    return ue, ie, user, item, test_pos


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 20), (2, 44), (3, 60)])
def test_recall_at_k_csr_bitwise(seed, k):
    """k up to past the catalogue; ties forced by integer embeddings."""
    ue, ie, user, item, test_pos = _recall_case(seed)
    csr = bpr.build_user_csr(user, item, len(ue))
    want = jbpr.recall_at_k(ue, ie, jbpr.build_user_csr(user, item, len(ue)),
                            test_pos, k)
    for u, i in ((ue, ie), (torch.from_numpy(ue), torch.from_numpy(ie))):
        got = bpr.recall_at_k(u, i, csr, test_pos, k)
        assert got == want and type(got) is float


@pytest.mark.parametrize("seed", [0, 4])
def test_recall_at_k_dense_mask_bitwise_with_warning(seed):
    ue, ie, user, item, test_pos = _recall_case(seed)
    mask = np.zeros((len(ue), len(ie)), bool)
    mask[user, item] = True
    with pytest.warns(DeprecationWarning, match="deprecated"):
        want = jbpr.recall_at_k(ue, ie, mask, test_pos, 10)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = bpr.recall_at_k(ue, ie, mask, test_pos, 10)
    assert got == want
    with warnings.catch_warnings():            # the CSR form warns nothing
        warnings.simplefilter("error")
        csr = bpr.build_user_csr(user, item, len(ue))
        assert bpr.recall_at_k(ue, ie, csr, test_pos, 10) == want


@pytest.mark.parametrize("mask", [np.zeros((30, 45), np.int32),
                                  np.zeros(30 * 45, bool)])
def test_recall_at_k_rejects_a_non_boolean_dense_mask(mask):
    ue, ie, _, _, test_pos = _recall_case(0)
    for fn in (jbpr.recall_at_k, bpr.recall_at_k):
        with pytest.raises(TypeError, match="2-D boolean"):
            fn(ue, ie, mask, test_pos, 5)


def test_recall_at_k_no_held_out_items():
    ue, ie, user, item, _ = _recall_case(5)
    csr = bpr.build_user_csr(user, item, len(ue))
    empty = [np.zeros(0, np.int64)] * len(ue)
    assert bpr.recall_at_k(ue, ie, csr, empty) == \
        jbpr.recall_at_k(ue, ie, csr, empty) == 0.0


@pytest.mark.parametrize("peak,warmup", [(0.147, 7), (1e-3, 0), (0.0735, 3),
                                         (0.3, 1000), (2.5, 1)])
def test_warmup_linear_lr_bitwise(peak, warmup):
    steps = list(range(0, 3 * max(warmup, 1) + 2)) + [10**6]
    for t in steps:
        want = np.asarray(jopt.WarmupLinearLR(peak, warmup)(
            jnp.asarray(t, jnp.int32)))
        got = WarmupLinearLR(peak, warmup)(torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.numpy().view(np.int32) == want.view(np.int32), t


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e6])
def test_global_norm_clip_within_fp32(max_norm):
    rng = np.random.default_rng(7)
    tree = {"w2": [rng.standard_normal((6, 5)).astype(np.float32),
                   rng.standard_normal(3).astype(np.float32)],
            "b": rng.standard_normal((4, 4)).astype(np.float32),
            "a": {"x": rng.standard_normal(9).astype(np.float32)}}
    jclip, jnorm = jopt.global_norm_clip(jax.tree.map(jnp.asarray, tree),
                                         max_norm)
    clip, norm = global_norm_clip(jax.tree.map(torch.from_numpy, tree),
                                  max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    got = tree_paths(clip)
    want = [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(jclip)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)

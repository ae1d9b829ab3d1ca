"""The port's host-side data and graph build against the reference: the
same seed gives byte-equal arrays (same values, same dtypes)."""
import numpy as np
import pytest

from repro.core.bpr import build_user_csr as j_build_user_csr
from repro.data import synth as jsynth
from repro.kernels.spmm import build_csr_by_dst as j_build_csr_by_dst
from repro_torch.core.bpr import build_user_csr
from repro_torch.data import synth
from repro_torch.kernels.spmm import build_csr_by_dst


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("nu,ni,ne,seed", [(64, 48, 512, 0), (300, 120, 5000, 3),
                                           (16, 16, 400, 7)])
def test_generate_bipartite_byte_equal(nu, ni, ne, seed):
    a = synth.generate_bipartite(nu, ni, ne, seed=seed)
    b = jsynth.generate_bipartite(nu, ni, ne, seed=seed)
    _equal(a.user, b.user)
    _equal(a.item, b.item)
    assert (a.n_users, a.n_items, a.n_edges) == (b.n_users, b.n_items, b.n_edges)
    assert a.density == b.density


def test_scaled_and_stats_byte_equal():
    assert synth.DATASET_STATS == jsynth.DATASET_STATS
    _equal(synth.zipf_probs(100), jsynth.zipf_probs(100))
    a = synth.scaled("movielens-10m", 8000, seed=0)
    b = jsynth.scaled("movielens-10m", 8000, seed=0)
    _equal(a.user, b.user)
    _equal(a.item, b.item)
    assert (a.n_users, a.n_items) == (b.n_users, b.n_items)


@pytest.mark.parametrize("frac,seed", [(0.1, 0), (0.25, 5)])
def test_train_test_split_byte_equal(frac, seed):
    data = synth.generate_bipartite(80, 60, 900, seed=1)
    tr, te = synth.train_test_split(data, frac, seed=seed)
    jtr, jte = jsynth.train_test_split(jsynth.generate_bipartite(80, 60, 900,
                                                                 seed=1),
                                       frac, seed=seed)
    for x, y in ((tr, jtr), (te, jte)):
        _equal(x.user, y.user)
        _equal(x.item, y.item)


@pytest.mark.parametrize("masked", [False, True])
def test_build_csr_by_dst_byte_equal(masked):
    rng = np.random.default_rng(2)
    n, e = 40, 300
    dst = rng.integers(0, n // 2, e).astype(np.int32)     # empty rows too
    src = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) > 0.3 if masked else None
    got = build_csr_by_dst(dst, src, n, edge_mask=mask)
    want = j_build_csr_by_dst(dst, src, n, edge_mask=mask)
    for a, b in zip(got, want):
        _equal(a, b)


def test_build_csr_by_dst_zero_edges():
    got = build_csr_by_dst(np.zeros(0, np.int32), np.zeros(0, np.int32), 5)
    want = j_build_csr_by_dst(np.zeros(0, np.int32), np.zeros(0, np.int32), 5)
    for a, b in zip(got, want):
        _equal(a, b)


def test_build_user_csr_and_group_by_user_byte_equal():
    data = synth.generate_bipartite(50, 70, 600, seed=4)
    for a, b in zip(build_user_csr(data.user, data.item, 55),
                    j_build_user_csr(data.user, data.item, 55)):
        _equal(a, b)
    got = synth.group_by_user(data.user, data.item, 55)
    want = jsynth.group_by_user(data.user, data.item, 55)
    assert len(got) == len(want) == 55
    for a, b in zip(got, want):
        _equal(a, b)

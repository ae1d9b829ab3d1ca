"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need an NVIDIA GPU and the CUDA toolkit, and skip
without one.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, ops, ref
from repro_torch.kernels.spmm import build_csr_by_dst

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("d", [128, 100])
def test_spmm_kernel_matches_plain(dev, reduce, d):
    rng = np.random.default_rng(d)
    n, e = 500, 3000
    dst = rng.integers(0, n // 2, e).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    indptr, src_sorted, _ = build_csr_by_dst(dst, src, n)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    ip = torch.from_numpy(indptr).to(dev, torch.int64)
    s = torch.from_numpy(src_sorted).to(dev)
    before = launch_counts()["spmm_csr"]
    got = ops.spmm_csr(reduce, x, ip, s, n, gather=True)
    assert launch_counts()["spmm_csr"] == before + 1
    want = ref.spmm_csr_ref(reduce, x, ip, s, n, gather=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_kernel_matches_plain(dev, combiner):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((300, 128)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 300, (64, 4)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((64, 4)) > 0.3).to(dev)
    got = ops.embedding_bag(table, ids, mask, combiner)
    want = ref.embedding_bag_ref(table, ids, mask, combiner)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fused_topk_kernel_bitwise_on_integer_ties(dev):
    rng = np.random.default_rng(2)
    ue = rng.integers(-2, 3, (40, 128)).astype(np.float32)
    ie = np.repeat(rng.integers(-2, 3, (400, 128)).astype(np.float32), 3, 0)
    seen = rng.integers(0, 1200, (40, 30)).astype(np.int32)
    mask = rng.random((40, 30)) < 0.5
    args = [torch.from_numpy(a).to(dev) for a in (ue, ie, seen, mask)]
    s_k, i_k = ops.fused_topk_score(*args, k=25, n_items=1200)
    s_p, i_p = ref.fused_topk_score_ref(*args, k=25, n_items=1200,
                                        item_block=1024)
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)

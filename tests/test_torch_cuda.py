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
from repro_torch.optim.optimizers import tree_leaves

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


@pytest.mark.parametrize("d,epilogue", [(128, False), (100, True), (37, False),
                                        (130, True)])
def test_hadamard_kernel_matches_plain(dev, d, epilogue):
    """General form (x_idx != y_idx), empty rows, the scale + leaky-relu
    epilogue, float4 and scalar lanes."""
    rng = np.random.default_rng(d)
    n_src, n, e = 400, 300, 3000
    dst = rng.integers(0, n // 2, e).astype(np.int32)
    indptr, x_idx, perm = build_csr_by_dst(dst, rng.integers(0, n_src, e), n)
    y_idx = rng.integers(0, n, e).astype(np.int32)[perm]
    x = torch.from_numpy(rng.standard_normal((n_src, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    args = (x, y, torch.from_numpy(indptr).to(dev, torch.int64),
            torch.from_numpy(x_idx).to(dev), torch.from_numpy(y_idx).to(dev), n)
    kw = {}
    if epilogue:
        kw = dict(scale=torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(dev), slope=0.2)
    before = launch_counts()["hadamard_spmm"]
    got = ops.hadamard_spmm(*args, **kw)
    assert launch_counts()["hadamard_spmm"] == before + 1
    want = ref.hadamard_spmm_ref(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool((got[torch.from_numpy(np.diff(indptr) == 0).to(dev)] == 0).all())


def test_ngcf_training_step_on_card_matches_plain_route(dev):
    """One NGCF target batch (2 accumulated microbatches) on the kernels
    against the same batch with every kernel call on its plain version:
    loss to rtol 1e-5, each gradient leaf to 1e-4 relative in the norm
    (fp32 sums in other orders); then one Adam step launches each kernel
    the expected number of times."""
    from repro_torch.data import synth
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    data = synth.generate_bipartite(500, 300, 8000, seed=0)
    cfg = PipelineConfig(arch="ngcf", embed_dim=64, n_layers=2,
                         target_batch=1024, base_batch=1024, microbatch=512,
                         warmup_epochs=0)
    pipe = build_pipeline(cfg, data, device=dev)
    state = pipe.init_state()
    batch = pipe._next_target_batch(2, 0)
    loss_k, grads_k = pipe.grads_for_batch(state["params"], *batch)
    pipe.g.impl = "torch"
    before = launch_counts()
    loss_p, grads_p = pipe.grads_for_batch(state["params"], *batch)
    assert launch_counts() == before              # the plain route launched nothing
    pipe.g.impl = None
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for a, b in zip(tree_leaves(grads_k), tree_leaves(grads_p)):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())
    pipe.seek(0)
    before = launch_counts()
    new, loss = pipe.step_fn(state, 0)
    launched = {k: launch_counts()[k] - v for k, v in before.items()}
    # per microbatch and layer: 2 fused Hadamard forward + 4 backward,
    # 2 adjacency SpMMs forward + 2 backward
    assert launched["hadamard_spmm"] == 2 * 2 * 6
    assert launched["spmm_csr"] == 2 * 2 * 4
    assert abs(loss - loss_k) <= 1e-6 * abs(loss_k)
    assert not torch.equal(new["params"]["w1"][0], state["params"]["w1"][0])

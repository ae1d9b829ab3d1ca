"""The port's kernel layer on the CPU: each plain PyTorch version against
the reference's XLA oracle (``repro.kernels.ref``) and its Pallas kernel
in interpret mode, on the adversarial shapes of
tests/test_kernel_parity.py; plus the dispatch rules of
``repro_torch.kernels.ops``.  The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.spmm import build_csr_by_dst, spmm_csr_pallas
from repro.kernels.topk_score import fused_topk_score_pallas
from repro_torch.kernels import _build, launch_counts, ops, ref
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.spmm import spmm_csr_cuda
from repro_torch.kernels.topk_score import MAX_K, fused_topk_score_cuda

T = torch.from_numpy


# ------------------------------------------------------------------- spmm
def _spmm_case(reduce, gather, n, e, d):
    rng = np.random.default_rng(abs(hash((reduce, gather, n, e, d))) % 2**31)
    src = rng.integers(0, n, e).astype(np.int32)
    # all edges land on a strict subset of rows: empty rows exist
    dst = rng.integers(0, max(n // 2, 1), e).astype(np.int32)
    indptr, src_sorted, perm = build_csr_by_dst(dst, src, n)
    if gather:
        values = rng.standard_normal((n, d)).astype(np.float32)
    else:
        values = rng.standard_normal((e, d)).astype(np.float32)[perm]
    return values, indptr, src_sorted


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("n,e,d", [
    (9, 30, 100),     # D not a multiple of 128
    (13, 21, 37),     # everything ragged
    (6, 12, 130),     # D just over one lane tile
    (5, 1, 8),        # single edge
    (8, 0, 16),       # zero edges: every row empty
])
def test_spmm_ref_matches_reference(reduce, gather, n, e, d):
    values, indptr, src_sorted = _spmm_case(reduce, gather, n, e, d)
    got = ops.spmm_csr(reduce, T(values), T(indptr).long(), T(src_sorted), n,
                       gather=gather)
    want = jref.spmm_csr_ref(reduce, jnp.asarray(values), jnp.asarray(indptr),
                             jnp.asarray(src_sorted), n, gather=gather)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    empty = np.diff(indptr) == 0
    assert empty.any()
    np.testing.assert_array_equal(got.numpy()[empty], 0.0)


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("gather", [False, True])
def test_spmm_ref_matches_pallas_interpret(reduce, gather):
    n, e, d = 9, 30, 100
    values, indptr, src_sorted = _spmm_case(reduce, gather, n, e, d)
    got = ref.spmm_csr_ref(reduce, T(values), T(indptr), T(src_sorted), n,
                           gather=gather)
    want = spmm_csr_pallas(reduce, jnp.asarray(values), jnp.asarray(indptr),
                           jnp.asarray(src_sorted), n, row_block=4,
                           gather=gather, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_spmm_ref_integer_inputs_are_exact():
    """Integer-valued rows: the summation order cannot matter."""
    rng = np.random.default_rng(5)
    n, e, d = 20, 90, 24
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    indptr, src_sorted, _ = build_csr_by_dst(dst, src, n)
    values = rng.integers(-3, 4, (n, d)).astype(np.float32)
    got = ref.spmm_csr_ref("sum", T(values), T(indptr), T(src_sorted), n,
                           gather=True)
    want = jref.spmm_csr_ref("sum", jnp.asarray(values), jnp.asarray(indptr),
                             jnp.asarray(src_sorted), n, gather=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- embedding bag
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,b,l,d", [
    (17, 5, 3, 100),   # D % 128 != 0
    (9, 1, 4, 37),     # single bag
    (33, 7, 2, 130),
    (20, 6, 1, 16),    # L = 1: the serving row gather
])
def test_embedding_bag_ref_matches_reference(combiner, v, b, l, d):
    rng = np.random.default_rng(abs(hash((combiner, v, b, l, d))) % 2**31)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    mask = rng.random((b, l)) > 0.4
    mask[0, :] = False                       # a fully-empty bag
    got = ops.embedding_bag(T(table), T(ids), T(mask), combiner)
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(mask), combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[0], 0.0)   # empty bag -> 0
    if combiner == "sum":
        pal = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(mask), combiner, bag_block=4,
                                   interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------- fused serving kernel
def _fused_case(case):
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    b, ni, d, k, blk, L = 9, 37, 12, 5, 8, 4
    ue = rng.integers(-2, 3, (b, d)).astype(np.float32)
    ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
    seen = rng.integers(0, ni, (b, L)).astype(np.int32)
    mask = rng.random((b, L)) < 0.5
    if case == "integer_ties":
        ie = np.repeat(ie[: ni // 3 + 1], 3, axis=0)[:ni]  # duplicate rows
    elif case == "neg_zero":
        ue = np.full((b, d), -1.0, np.float32)
        ie[::2] = 0.0                       # (-1)·0 = -0.0 pre-canonical
    elif case == "k_gt_catalogue":
        ni, k = 6, 11
        ie = ie[:ni]
        seen = np.minimum(seen, ni - 1)
    elif case == "fully_masked":
        ni, L = 6, 6
        ie = ie[:ni]
        seen = np.broadcast_to(np.arange(ni, dtype=np.int32), (b, ni)).copy()
        mask = np.ones((b, ni), bool)       # every candidate masked
    elif case == "ragged_d":
        d, b, blk = 130, 7, 5               # nothing divides anything
        ue = rng.integers(-2, 3, (b, d)).astype(np.float32)
        ie = rng.integers(-2, 3, (ni, d)).astype(np.float32)
        seen, mask = seen[:b], mask[:b]
    elif case == "empty_seen":
        seen = np.zeros((b, 0), np.int32)
        mask = np.zeros((b, 0), bool)
    return ue, ie, seen, mask, k, blk, ni


CASES = ["integer_ties", "neg_zero", "k_gt_catalogue", "fully_masked",
         "ragged_d", "empty_seen"]


@pytest.mark.parametrize("case", CASES)
def test_fused_topk_ref_bitwise_matches_reference(case):
    """Integer-valued inputs: ids and scores equal the XLA oracle's bit for
    bit, ties included (score desc, id asc), for two item blocks."""
    ue, ie, seen, mask, k, blk, ni = _fused_case(case)
    for block in (blk, 64):
        s_t, i_t = ops.fused_topk_score(T(ue), T(ie), T(seen), T(mask), k=k,
                                        n_items=ni, item_block=block)
        s_j, i_j = jref.fused_topk_score_ref(
            jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen),
            jnp.asarray(mask), k=k, item_block=block, n_items=ni)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        assert i_t.dtype == torch.int32 and s_t.dtype == torch.float32
    if case == "fully_masked":
        assert (i_t == -1).all() and torch.isneginf(s_t).all()
    if case == "k_gt_catalogue":
        assert (i_t[:, ni:] == -1).all() and torch.isneginf(s_t[:, ni:]).all()
    if case == "neg_zero":
        assert not torch.signbit(s_t[torch.isfinite(s_t) & (s_t == 0)]).any()


@pytest.mark.parametrize("case", ["integer_ties", "ragged_d"])
def test_fused_topk_ref_matches_pallas_interpret(case):
    ue, ie, seen, mask, k, blk, ni = _fused_case(case)
    s_t, i_t = ref.fused_topk_score_ref(T(ue), T(ie), T(seen), T(mask), k=k,
                                        item_block=blk, n_items=ni)
    s_p, i_p = fused_topk_score_pallas(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen),
        jnp.asarray(mask), k=k, item_block=blk, n_items=ni, user_tile=4,
        interpret=True)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_p))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))


def test_merge_topk_order_is_score_desc_id_asc():
    """The explicit tie rule: equal scores rank by id; the carry's
    (-inf, -1) seeds stay ahead of masked candidates."""
    carry_s = torch.tensor([[5.0, float("-inf"), float("-inf")]])
    carry_i = torch.tensor([[7, -1, -1]], dtype=torch.int32)
    s = torch.tensor([[5.0, 6.0, float("-inf"), 5.0]])
    i = torch.tensor([[9, 12, 10, 3]], dtype=torch.int32)
    top_s, top_i = ref.merge_topk(carry_s, carry_i, s, i, 5)
    assert top_i.tolist() == [[12, 3, 7, 9, -1]]
    assert top_s.tolist() == [[6.0, 5.0, 5.0, 5.0, float("-inf")]]


# --------------------------------------------------------------- dispatch
def _cpu_args():
    rng = np.random.default_rng(0)
    values, indptr, src = _spmm_case("sum", True, 6, 10, 8)
    table = T(rng.standard_normal((6, 8)).astype(np.float32))
    ids = torch.zeros((3, 1), dtype=torch.int32)
    mask = torch.ones((3, 1), dtype=torch.bool)
    return {
        "spmm_csr": lambda **kw: ops.spmm_csr("sum", T(values),
                                              T(indptr).long(), T(src), 6,
                                              gather=True, **kw),
        "embedding_bag": lambda **kw: ops.embedding_bag(table, ids, mask,
                                                        **kw),
        "fused_topk_score": lambda **kw: ops.fused_topk_score(
            table[:3], table, ids, mask, k=2, n_items=6, **kw),
    }


@pytest.mark.parametrize("name", ["spmm_csr", "embedding_bag",
                                  "fused_topk_score"])
def test_impl_cuda_on_cpu_tensor_raises(name):
    call = _cpu_args()[name]
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        call(impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        call(impl="pallas")
    before = launch_counts()
    call()                               # CPU tensor: the plain version
    call(impl="torch")
    assert launch_counts() == before     # no kernel launched


def test_wrappers_refuse_cpu_tensors_and_bad_k():
    with pytest.raises(ValueError, match="CUDA"):
        spmm_csr_cuda("sum", torch.zeros(2, 4), torch.zeros(3, dtype=torch.long),
                      torch.zeros(0, dtype=torch.int32), 2, gather=True)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(torch.zeros(2, 4), torch.zeros((1, 1), dtype=torch.int32),
                           torch.ones((1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match=f"k <= {MAX_K}"):
        fused_topk_score_cuda(torch.zeros(1, 4), torch.zeros(3, 4),
                              torch.zeros((1, 0), dtype=torch.int32),
                              torch.zeros((1, 0), dtype=torch.bool),
                              k=MAX_K + 1, n_items=3)


def test_every_kernel_source_is_bound_and_annotated():
    """Each csrc/*.cu has a ctypes signature table, a versioned library
    name, and a source note naming the TPU kernel it replaces."""
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build.SIGNATURES)
    for name in sources:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces src/repro/kernels/" in text and "Bound:" in text
        assert "sm_90a" in text
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        assert path == _build.library_path(name)      # stable name
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    topk_src = (_build.CSRC / "topk_score.cu").read_text()
    assert f"constexpr int kMaxK = {MAX_K};" in topk_src   # wrapper's cap

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
from repro_torch.kernels.intent import intent_sddmm_cuda, intent_spmm_cuda
from repro_torch.kernels.spmm import spmm_csr_cuda
from repro_torch.kernels.topk_score import (ITEM_TILE, USER_TILE,
                                           fused_topk_score_cuda)

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


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("b,l", [(7, 1), (5, 4), (3, 0)])
def test_embedding_bag_plain_without_mask_equals_all_true_mask(combiner, b, l):
    """The port's fast path: ``mask=None`` with int64 ids gives the same
    bits as an all-true mask with int32 ids, and matches the reference's
    ``embedding_bag_ref`` with an all-true mask."""
    rng = np.random.default_rng(b * 10 + l)
    table = rng.standard_normal((23, 12)).astype(np.float32)
    ids = rng.integers(0, 23, (b, l)).astype(np.int32)
    full = np.ones((b, l), bool)
    want = ops.embedding_bag(T(table), T(ids), T(full), combiner)
    for i in (T(ids), T(ids).long()):
        got = ops.embedding_bag(T(table), i, None, combiner)
        assert got.dtype == torch.float32 and got.shape == (b, 12)
        assert got.numpy().tobytes() == want.numpy().tobytes()
    jwant = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(full), combiner)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)


def test_gather_rows_takes_the_callers_ids_without_a_mask():
    """``eval/topk.py::_gather_rows`` gives table rows for int32 and int64
    ids alike (the user batch and the item block of the sweep)."""
    from repro_torch.eval.topk import _gather_rows
    table = T(np.random.default_rng(3).standard_normal((9, 5))
              .astype(np.float32))
    for dtype in (torch.int32, torch.int64):
        ids = torch.tensor([4, 0, 8, 4], dtype=dtype)
        got = _gather_rows(table, ids, None)
        assert got.numpy().tobytes() == table[ids.long()].numpy().tobytes()


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
        "intent_spmm": lambda **kw: ops.intent_spmm(
            T(rng.random((10, 4)).astype(np.float32)), T(values),
            T(indptr).long(), T(src), 6, **kw),
        "intent_sddmm": lambda **kw: ops.intent_sddmm(
            table, T(values), T(indptr).long(), T(src), 4, **kw),
    }


@pytest.mark.parametrize("name", ["spmm_csr", "embedding_bag",
                                  "fused_topk_score", "intent_spmm",
                                  "intent_sddmm"])
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
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(torch.zeros(2, 4),
                           torch.zeros((1, 1), dtype=torch.int64), None)
    with pytest.raises(ValueError, match="max"):
        embedding_bag_cuda(torch.zeros(2, 4),
                           torch.zeros((1, 1), dtype=torch.int32), None,
                           "max")
    topk_args = (torch.zeros(1, 4), torch.zeros(3, 4),
                 torch.zeros((1, 0), dtype=torch.int32),
                 torch.zeros((1, 0), dtype=torch.bool))
    # every k is taken: k = 300, past the old cap of 256, fails on the
    # device check, not on its size
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_topk_score_cuda(*topk_args, k=300, n_items=3)
    with pytest.raises(ValueError, match="k must be >= 0"):
        fused_topk_score_cuda(*topk_args, k=-1, n_items=3)


def test_intent_wrappers_refuse_cpu_tensors_and_bad_widths():
    """DGCF's kernels: CPU tensors, K not dividing D, and (intent_sddmm)
    widths its lanes do not take are refused before any launch."""
    ip, src = torch.zeros(3, dtype=torch.long), torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        intent_spmm_cuda(torch.zeros(0, 4), torch.zeros(2, 8), ip, src, 2)
    with pytest.raises(ValueError, match="CUDA"):
        intent_sddmm_cuda(torch.zeros(2, 8), torch.zeros(2, 8), ip, src, 4)
    before = launch_counts()
    # the plain routes take any width K divides, in float64 too
    x = torch.ones(2, 6, dtype=torch.float64)
    assert ops.intent_spmm(torch.ones(0, 3, dtype=torch.float64), x, ip, src,
                           2).shape == (2, 6)
    assert ops.intent_sddmm(x, x, ip, src, 3).shape == (0, 3)
    assert launch_counts() == before


def test_every_kernel_source_is_bound_and_annotated():
    """Each csrc/*.cu has a ctypes signature table, a versioned library
    name, and a source note naming the TPU kernel it replaces, or saying
    it replaces none (DGCF's, whose model the JAX package lacks)."""
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build.SIGNATURES)
    for name in sources:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert ("Replaces src/repro/kernels/" in text
                or "Replaces no TPU kernel" in text) and "Bound:" in text
        assert "sm_90a" in text
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        assert path == _build.library_path(name)      # stable name
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    topk_src = (_build.CSRC / "topk_score.cu").read_text()
    assert f"constexpr int kUserTile = {USER_TILE};" in topk_src
    assert f"constexpr int kItemTile = {ITEM_TILE};" in topk_src
    assert "kMaxK" not in topk_src                          # no cap on k


# ------------------------------------------------- every dispatch entry
def _dispatch_case(name, rng):
    """(port call, reference oracle call) on one seeded small input."""
    if name == "sddmm":
        x = rng.standard_normal((7, 12)).astype(np.float32)
        y = rng.standard_normal((5, 12)).astype(np.float32)
        src = rng.integers(0, 7, 20).astype(np.int32)
        dst = rng.integers(0, 5, 20).astype(np.int32)
        mask = rng.random(20) < 0.7
        return (lambda: ops.sddmm("dot", T(x), T(y), T(src), T(dst),
                                  T(mask)),
                lambda: jref.sddmm_ref("dot", *map(jnp.asarray,
                                                   (x, y, src, dst, mask))))
    if name == "hadamard_spmm":
        n_src, n_dst, e, d = 9, 6, 25, 20
        dst = rng.integers(0, n_dst, e).astype(np.int32)
        x_idx = rng.integers(0, n_src, e).astype(np.int32)
        order = np.argsort(dst, kind="stable")
        indptr = np.zeros(n_dst + 1, np.int32)
        np.cumsum(np.bincount(dst, minlength=n_dst), out=indptr[1:])
        x_idx, y_idx = x_idx[order], dst[order]
        x = rng.standard_normal((n_src, d)).astype(np.float32)
        y = rng.standard_normal((n_dst, d)).astype(np.float32)
        args = (x, y, indptr, x_idx, y_idx)
        return (lambda: ops.hadamard_spmm(T(x), T(y), T(indptr).long(),
                                          T(x_idx), T(y_idx), n_dst),
                lambda: jref.hadamard_spmm_ref(*map(jnp.asarray, args),
                                               n_dst))
    ue = rng.standard_normal((4, 16)).astype(np.float32)
    cq = rng.integers(-127, 128, (6, 16)).astype(np.int8)
    scale = rng.random(6).astype(np.float32)
    radius = rng.random(6).astype(np.float32)
    args = (ue, cq, scale, radius)
    return (lambda: ops.ann_block_scores(*map(T, args)),
            lambda: jref.ann_block_scores_ref(*map(jnp.asarray, args)))


@pytest.mark.parametrize("name", ["sddmm", "hadamard_spmm",
                                  "ann_block_scores"])
def test_dispatch_plain_route_matches_reference_oracle(name):
    """Every ``ops`` dispatch entry on CPU tensors (its plain version)
    against the reference's ``repro.kernels.ref`` oracle, fp32 tolerance
    (rtol = atol = 1e-5); the three the cases above do not call (their
    adversarial shapes are in test_torch_sddmm.py, test_torch_hadamard.py
    and test_torch_ann.py)."""
    port, oracle = _dispatch_case(name, np.random.default_rng(7))
    before = launch_counts()
    got = port()
    assert launch_counts() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle()),
                               rtol=1e-5, atol=1e-5)

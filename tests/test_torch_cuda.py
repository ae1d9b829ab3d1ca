"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need an NVIDIA GPU and the CUDA toolkit, and skip
without one.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hadamard_spmm_cuda, launch_counts, ops, ref
from repro_torch.kernels.spmm import build_csr_by_dst
from repro_torch.optim.optimizers import tree_leaves
from topk_nan_cases import CASES as NAN_CASES
from topk_nan_cases import fused_case

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


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("l", [1, 8])
def test_embedding_bag_kernel_int64_ids_no_mask_bitwise(dev, combiner, l):
    """The fast path on the card: int64 ids and no mask, bitwise against
    the plain version and against int32 ids with an all-true mask; one
    launch per call."""
    rng = np.random.default_rng(l)
    table = torch.from_numpy(rng.standard_normal((300, 128)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 300, (256, l))).to(dev)
    assert ids.dtype == torch.int64
    before = launch_counts()["embedding_bag"]
    got = ops.embedding_bag(table, ids, None, combiner)
    assert launch_counts()["embedding_bag"] == before + 1
    assert torch.equal(got, ref.embedding_bag_ref(table, ids, None, combiner))
    full = torch.ones(ids.shape, dtype=torch.bool, device=dev)
    assert torch.equal(got, ops.embedding_bag(table, ids.int(), full,
                                              combiner))


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
    shared = hadamard_spmm_cuda.shared_launches
    new, loss = pipe.step_fn(state, 0)
    launched = {k: launch_counts()[k] - v for k, v in before.items()}
    # per microbatch and layer: 2 fused Hadamard forward + 4 backward (of
    # them the 2 d_x calls on one index, the shared-index route),
    # 2 adjacency SpMMs forward + 2 backward
    assert launched["hadamard_spmm"] == 2 * 2 * 6
    assert hadamard_spmm_cuda.shared_launches - shared == 2 * 2 * 2
    assert launched["spmm_csr"] == 2 * 2 * 4
    assert abs(loss - loss_k) <= 1e-6 * abs(loss_k)
    assert not torch.equal(new["params"]["w1"][0], state["params"]["w1"][0])


@pytest.mark.parametrize("b,nb,d", [(1, 1, 8), (7, 13, 37), (64, 130, 128),
                                    (64, 832, 128), (16384, 832, 128)])
@pytest.mark.parametrize("integer", [True, False])
def test_ann_block_scores_kernel_matches_plain(dev, b, nb, d, integer):
    """Bitwise on integer-valued users (radius on and off), else to
    rtol = atol = 1e-5; ragged B, nb and D, nb = 1, a whole-sweep B."""
    rng = np.random.default_rng(b + nb + d)
    ue = rng.integers(-3, 4, (b, d)) if integer \
        else rng.standard_normal((b, d))
    args = [torch.from_numpy(a).to(dev) for a in (
        ue.astype(np.float32), rng.integers(-127, 128, (nb, d)).astype(np.int8),
        (rng.random(nb) / 50).astype(np.float32),
        rng.random(nb).astype(np.float32))]
    for radius in (args[3], torch.zeros_like(args[3])):
        before = launch_counts()["ann_block_scores"]
        got = ops.ann_block_scores(*args[:3], radius)
        assert launch_counts()["ann_block_scores"] == before + 1
        want = ref.ann_block_scores_ref(*args[:3], radius)
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_tiered_ann_recommender_on_card_equals_device_resident(dev, store):
    """Both tables in pinned host memory behind the hot-row cache, served
    on the card, against the same tables resident on the card: ids and
    scores bitwise (the same kernels on the same bytes), and the coarse
    kernel launched."""
    from repro_torch.eval import Recommender
    from repro_torch.memory import HotRowCache
    from repro_torch.optim.compression import (dequantize_rows_int8,
                                               quantize_rows_int8)
    rng = np.random.default_rng(3)
    ue = rng.standard_normal((500, 64)).astype(np.float32)
    ie = rng.standard_normal((3000, 64)).astype(np.float32)
    kw = dict(k=10, user_batch=64, item_block=256, ann=True, keep_frac=0.25,
              ann_block=32, topology="h100-hbm-host", device=dev)
    tiered = Recommender(ue, ie, cache_rows=128, embed_store=store,
                         pins={"serve/user_embed": "slow",
                               "serve/item_embed": "slow"}, **kw)
    if store == "int8":     # the device-resident arm serves the same bytes
        ue, ie = (dequantize_rows_int8(*quantize_rows_int8(t))
                  for t in (ue, ie))
    resident = Recommender(ue, ie, **kw)
    assert isinstance(tiered.item_e, HotRowCache)
    assert tiered.item_e.backing.q.is_pinned() if store == "int8" \
        else tiered.item_e.backing.arr.is_pinned()
    before = launch_counts()["ann_block_scores"]
    for q in np.array_split(rng.integers(0, 500, 256), 4):
        i_t, s_t = tiered.recommend(q)
        i_r, s_r = resident.recommend(q)
        np.testing.assert_array_equal(i_t, i_r)
        np.testing.assert_array_equal(s_t, s_r)
    assert launch_counts()["ann_block_scores"] == before + 8
    assert tiered.cache_stats()["serve/item_embed"]["hits"] > 0


@pytest.mark.parametrize("op", ["mul", "add", "dot", "copy"])
@pytest.mark.parametrize("d", [128, 37, 1])
@pytest.mark.parametrize("integer", [True, False])
def test_sddmm_kernel_matches_plain(dev, op, d, integer):
    """All four ops with coeff, ~30% of edges masked (first and last
    too), N_x != N_y, float4 and scalar lanes; integer-valued inputs
    bitwise, else 'mul'/'add'/'copy' bitwise (one rounding each) and
    'dot' to rtol = atol = 1e-5."""
    rng = np.random.default_rng(d + 7)
    n_x, n_y, e = 300, 170, 1000

    def feats(*shape):
        if integer:
            return rng.integers(-3, 4, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    mask = rng.random(e) > 0.3
    mask[0] = mask[-1] = False
    args = [torch.from_numpy(a).to(dev) for a in (
        feats(n_x, d), feats(n_y, d), rng.integers(0, n_x, e).astype(np.int32),
        rng.integers(0, n_y, e).astype(np.int32), mask)]
    coeff = torch.from_numpy(feats(e)).to(dev)
    before = launch_counts()["sddmm"]
    got = ops.sddmm(op, *args, coeff)
    assert launch_counts()["sddmm"] == before + 1
    want = ref.sddmm_ref(op, *args, coeff)
    if integer or op != "dot":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dead = ~args[4]
    assert bool((got[dead] == 0).all()) and not bool(got[dead].signbit().any())


def _grouped_case(rng, d, integer, dev):
    """Users x items with user 5 holding a group of 5 chunks and a half,
    ~25 % of the real edges masked in the middle, masked padding at the
    end (user 0, item 0); float or integer-valued tables and coeff."""
    from repro_torch.core.graph import pad_edges
    from repro_torch.kernels.sddmm import CHUNK
    n_users, n_items, e_real = 300, 170, 6 * CHUNK + 900
    user = rng.integers(0, n_users, e_real).astype(np.int32)
    user[rng.permutation(e_real)[:11 * CHUNK // 2]] = 5
    item = rng.integers(0, n_items, e_real).astype(np.int32)
    u, i, mask = pad_edges(user, item, e_real + 77)
    mask[:e_real] &= rng.random(e_real) > 0.25

    def feats(*shape):
        if integer:
            return rng.integers(-3, 4, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    return [torch.from_numpy(a).to(dev) for a in (
        feats(n_users, d), feats(n_items, d), u, i, mask, feats(u.size))]


@pytest.mark.parametrize("keyed", ["src", "dst"])
@pytest.mark.parametrize("op", ["mul", "add", "dot", "copy"])
@pytest.mark.parametrize("d", [128, 37, 1, 130, 516])
def test_sddmm_grouped_kernel_matches_plain(dev, d, op, keyed):
    """The kernel walking user groups (keyed on the call's src, as at O3,
    or on its dst, as in O2's second call; 'copy' only on src) with a
    group longer than five chunks, on rows of one to five 32-lane column
    slabs (16-byte lanes at D = 128 and 516): one launch; equal to the
    same kernel without groups bit for bit; integer-valued inputs bitwise
    against the plain version, else 'mul'/'add'/'copy' bitwise and 'dot'
    to rtol = atol = 1e-5; masked edges +0.0."""
    from repro_torch.kernels.sddmm import group_edges
    if op == "copy" and keyed == "dst":
        keyed = "src"
    rng = np.random.default_rng(d + len(op))
    for integer in (True, False):
        xu, xi, u, i, mask, coeff = _grouped_case(rng, d, integer, dev)
        args = (xu, xi, u, i, mask) if keyed == "src" \
            else (xi, xu, i, u, mask)
        groups = group_edges(u, i, mask)
        before = launch_counts()["sddmm"]
        got = ops.sddmm(op, *args, coeff, groups=groups)
        assert launch_counts()["sddmm"] == before + 1
        assert torch.equal(got, ops.sddmm(op, *args, coeff))
        want = ref.sddmm_ref(op, *args, coeff)
        if integer or op != "dot":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        dead = ~mask
        assert bool((got[dead] == 0).all())
        assert not bool(got[dead].signbit().any())


def test_sddmm_kernel_refuses_foreign_groups(dev):
    """Groups of another graph (equal values, other storage), of another
    mask, or keyed on dst for 'copy' raise on the card; nothing launches."""
    from repro_torch.kernels.sddmm import group_edges
    xu, xi, u, i, mask, _ = _grouped_case(np.random.default_rng(3), 16,
                                          True, dev)
    groups = group_edges(u, i, mask)
    before = launch_counts()["sddmm"]
    for bad, args in (
            (group_edges(u.clone(), i.clone(), mask), (xu, xi, u, i, mask)),
            (groups, (xu, xi, u, i, mask.clone())),
            (groups, (xu, xi, i, i, mask))):
        with pytest.raises(ValueError, match="sddmm groups"):
            ops.sddmm("mul", *args, groups=bad)
    with pytest.raises(ValueError, match="do not belong to this call"):
        ops.sddmm("copy", xi, xu, i, u, mask, groups=groups)
    assert launch_counts()["sddmm"] == before


def test_coo_ngcf_groups_keep_launch_counts(dev):
    """NGCF forwards with the user groups in play: one sddmm launch per
    layer at O3, two at O2, none at O1 with the plain route; the groups
    are built once for the graph; O2 and O3 equal O1 (plain) to 1e-4
    relative in the norm (index_add_ sums in another order)."""
    from repro_torch.core import graph, ngcf
    from repro_torch.data import synth
    from repro_torch.kernels.sddmm import group_edges
    data = synth.generate_bipartite(500, 300, 8000, seed=1)
    g = graph.bipartite_from_numpy(data.user, data.item, 500, 300,
                                   data.n_edges + 100, device=dev)
    p = ngcf.init_params(1, 500, 300, 64, 2, device=dev)
    builds = group_edges.builds
    outs = {}
    for level, impl, launches in ((3, None, 2), (2, None, 4),
                                  (1, "torch", 0)):
        before = launch_counts()["sddmm"]
        with torch.no_grad():
            outs[level] = ngcf.forward(p, g, opt_level=level, impl=impl)
        assert launch_counts()["sddmm"] == before + launches
    assert group_edges.builds == builds + 1
    for level in (2, 3):
        for a, b in zip(outs[level], outs[1]):
            assert float((a - b).norm()) <= 1e-4 * float(b.norm())


def test_coo_ngcf_o3_on_card_matches_plain_route(dev):
    """A small NGCF forward and BPR gradients at O3 on the card: one
    sddmm launch per layer, equal to the same call on the plain route
    (loss to rtol 1e-5, each gradient leaf to 1e-4 relative in the
    norm: index_add_ sums in another order)."""
    from repro_torch.core import graph, ngcf
    from repro_torch.core.train_step import bpr_value_and_grad
    from repro_torch.data import synth
    data = synth.generate_bipartite(500, 300, 8000, seed=0)
    g = graph.bipartite_from_numpy(data.user, data.item, 500, 300,
                                   data.n_edges + 100, device=dev)
    p = ngcf.init_params(0, 500, 300, 64, 2, device=dev)
    rng = np.random.default_rng(0)
    batch = [torch.from_numpy(rng.integers(0, n, 512)).to(dev)
             for n in (500, 300, 300)]
    before = launch_counts()["sddmm"]
    loss_k, grads_k = bpr_value_and_grad(
        lambda q: ngcf.forward(q, g, opt_level=3), p, *batch)
    assert launch_counts()["sddmm"] == before + 2
    loss_p, grads_p = bpr_value_and_grad(
        lambda q: ngcf.forward(q, g, opt_level=3, impl="torch"), p, *batch)
    assert launch_counts()["sddmm"] == before + 2
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b in zip(tree_leaves(grads_k), tree_leaves(grads_p)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())


def _split_graph(case, t, rng):
    """(indptr i64, n_nodes, src i32) for the row-split cases: one row
    holding > 50 % of E (> 100k edges); rows of T - 1, T and T + 1 edges
    with a row that starts exactly on a chunk boundary and trailing empty
    rows; E = 0; and an indptr longer than n_nodes + 1."""
    degs = [t - 1, t, t + 1, 0, 0, 5]
    degs.append((-(sum(degs) + len(degs) + 1)) % t)   # next row on a boundary
    degs += [3 * t, 1, 0, t - 1, 0, 0]
    n = len(degs)
    if case == "long_row":
        degs = rng.zipf(1.5, 2000).clip(0, 500)
        degs[17] = 120_000
        degs[-5:] = 0
        n = len(degs)
    elif case == "no_edges":
        degs = [0] * (2 * t + 3)
        n = len(degs)
    elif case == "long_indptr":
        degs += [t + 1, 7, 2 * t]
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    src = rng.integers(0, 500, int(indptr[-1])).astype(np.int32)
    return indptr, n, src


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("case", ["long_row", "boundaries", "no_edges",
                                  "long_indptr"])
def test_spmm_kernel_splits_long_rows(dev, case, reduce, gather):
    """The row split against the plain version: a 120k-edge row (> 50 %
    of E), rows of T - 1, T and T + 1 edges, a row on a chunk boundary,
    trailing empty rows, E = 0 and an over-long indptr; sum to |err| <=
    1e-5 + 1e-5 x the sum of |terms|, max exactly; two calls bitwise
    equal."""
    from repro_torch.kernels.spmm import CHUNK
    rng = np.random.default_rng(len(case))
    indptr, n, src = _split_graph(case, CHUNK, rng)
    rows = 500 if gather else len(src)
    x = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32)
                         ).to(dev)
    args = (torch.from_numpy(indptr).to(dev), torch.from_numpy(src).to(dev), n)
    got = ops.spmm_csr(reduce, x, *args, gather=gather)
    again = ops.spmm_csr(reduce, x, *args, gather=gather)
    assert torch.equal(got, again)
    want = ref.spmm_csr_ref(reduce, x, *args, gather=gather)
    if reduce == "max":
        assert torch.equal(got, want)
    else:
        abs_sum = ref.spmm_csr_ref("sum", x.abs(), *args, gather=gather)
        assert bool(((got - want).abs() <= 1e-5 + 1e-5 * abs_sum).all())
    empty = torch.from_numpy(np.diff(indptr[: n + 1]) == 0).to(dev)
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("b,nb,d,offset", [
    (64, 832, 128, 0),      # the serving batch: 16 x 32 tiles, 16-byte loads
    (37, 833, 144, 0),      # ragged B and nb on the serving tiles
    (37, 833, 144, 1),      # ue 4 bytes off 16-byte alignment: scalar loads
    (50, 13, 130, 0),       # D % 16 != 0
    (20, 100, 256, 0),      # D = 256: two staged chunks (224 + 32 columns)
    (9, 40, 300, 0),        # D = 300: two chunks, the second ragged
    (1000, 1100, 48, 0),    # the sweep tiles, ragged on both axes
])
def test_ann_block_scores_tiles_bitwise_on_integers(dev, b, nb, d, offset):
    """Both tile shapes and both load widths, bitwise against the plain
    version on integer-valued users, radius on and off."""
    rng = np.random.default_rng(b * nb + d)
    flat = torch.from_numpy(rng.integers(-3, 4, b * d + offset)
                            .astype(np.float32)).to(dev)
    ue = flat[offset:].view(b, d)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-127, 128, (nb, d)).astype(np.int8),
        (rng.random(nb) / 50).astype(np.float32),
        rng.random(nb).astype(np.float32))]
    for radius in (args[2], torch.zeros_like(args[2])):
        got = ops.ann_block_scores(ue, args[0], args[1], radius)
        assert torch.equal(got, ref.ann_block_scores_ref(ue, args[0], args[1],
                                                         radius))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("case", ["long_row", "boundaries", "no_edges",
                                  "long_indptr"])
def test_hadamard_kernel_splits_long_rows(dev, case, epilogue, integer):
    """The row split of hadamard_spmm against the plain version on the
    spmm split graphs (a 120k-edge row, rows of T - 1, T and T + 1 edges,
    a row on a chunk boundary, trailing empty rows, E = 0, an over-long
    indptr), general indices, with and without the (scale, leaky-relu)
    epilogue, negative scales included: bitwise on integer-valued inputs,
    else |err| <= 1e-5 + 1e-5 x the sum of |terms|; two calls bitwise."""
    from repro_torch.kernels.hadamard_spmm import CHUNK
    rng = np.random.default_rng(len(case) + 10 * epilogue)
    indptr, n, x_idx = _split_graph(case, CHUNK, rng)
    n_y = len(indptr) - 1
    y_idx = rng.integers(0, n_y, len(x_idx)).astype(np.int32)

    def feats(*shape):
        if integer:
            return rng.integers(-3, 4, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    x = torch.from_numpy(feats(500, 128)).to(dev)
    y = torch.from_numpy(feats(n_y, 128)).to(dev)
    scale = torch.from_numpy(feats(n)).to(dev)
    args = (torch.from_numpy(indptr).to(dev), torch.from_numpy(x_idx).to(dev),
            torch.from_numpy(y_idx).to(dev), n)
    kw = dict(scale=scale, slope=0.2) if epilogue else {}
    got = ops.hadamard_spmm(x, y, *args, **kw)
    assert torch.equal(got, ops.hadamard_spmm(x, y, *args, **kw))
    want = ref.hadamard_spmm_ref(x, y, *args, **kw)
    if integer:
        assert torch.equal(got, want)
    else:
        abs_kw = dict(scale=scale.abs()) if epilogue else {}
        abs_sum = ref.hadamard_spmm_ref(x.abs(), y.abs(), *args, **abs_kw)
        assert bool(((got - want).abs() <= 1e-5 + 1e-5 * abs_sum).all())
    empty = torch.from_numpy(np.diff(indptr[: n + 1]) == 0).to(dev)
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("d", [128, 6])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("case", ["long_row", "boundaries", "no_edges",
                                  "long_indptr"])
def test_hadamard_shared_index_bitwise_equals_general(dev, case, epilogue,
                                                      integer, d):
    """One index tensor as both x_idx and y_idx (the shared-index route:
    x * y formed once per node, one gathered row per edge) against the
    same content in two tensors (the general route), bit for bit, on the
    split graphs, with and without the epilogue, integer-valued and normal
    inputs, D = 128 (float4 lanes) and D = 6 (scalar lanes), x and y of
    different row counts; one launch per call, and only the shared call
    counted in ``shared_launches``."""
    from repro_torch.kernels.hadamard_spmm import CHUNK
    rng = np.random.default_rng(len(case) + 10 * epilogue + d)
    indptr, n, src = _split_graph(case, CHUNK, rng)

    def feats(*shape):
        if integer:
            return rng.integers(-3, 4, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    x = torch.from_numpy(feats(500, d)).to(dev)
    y = torch.from_numpy(feats(620, d)).to(dev)
    scale = torch.from_numpy(feats(n)).to(dev)
    ip = torch.from_numpy(indptr).to(dev)
    idx = torch.from_numpy(src).to(dev)
    kw = dict(scale=scale, slope=0.2) if epilogue else {}
    before = launch_counts()["hadamard_spmm"]
    shared = hadamard_spmm_cuda.shared_launches
    got = ops.hadamard_spmm(x, y, ip, idx, idx, n, **kw)
    assert hadamard_spmm_cuda.shared_launches == shared + (len(src) > 0)
    general = ops.hadamard_spmm(x, y, ip, idx, idx.clone(), n, **kw)
    assert hadamard_spmm_cuda.shared_launches == shared + (len(src) > 0)
    assert launch_counts()["hadamard_spmm"] == before + 2 * (len(src) > 0)
    assert torch.equal(got, general)
    assert torch.equal(got, ops.hadamard_spmm(x, y, ip, idx, idx, n, **kw))
    if integer:
        assert torch.equal(got, ref.hadamard_spmm_ref(x, y, ip, idx, idx, n,
                                                      **kw))
    empty = torch.from_numpy(np.diff(indptr[: n + 1]) == 0).to(dev)
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("k", [300, 2000])
def test_fused_topk_kernel_large_k(dev, k):
    """Past the old cap of 256 (k = 2,000 keeps the lists in the global
    scratch): ids and scores bitwise against the plain version on integer
    ties, at a batch of two user tiles with the catalogue split."""
    rng = np.random.default_rng(k)
    ue = rng.integers(-2, 3, (70, 128)).astype(np.float32)
    ie = np.repeat(rng.integers(-2, 3, (1700, 128)).astype(np.float32), 3, 0)
    seen = rng.integers(0, 5100, (70, 30)).astype(np.int32)
    mask = rng.random((70, 30)) < 0.5
    args = [torch.from_numpy(a).to(dev) for a in (ue, ie, seen, mask)]
    s_k, i_k = ops.fused_topk_score(*args, k=k, n_items=5100)
    s_p, i_p = ref.fused_topk_score_ref(*args, k=k, n_items=5100,
                                        item_block=1024)
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)


def test_topk_routes_at_k_300_on_card_match_plain(dev):
    """streaming_topk's fused route and ann_topk at k = 300 launch the
    kernel and return the plain route's ids and scores, bitwise
    (integer-valued tables, many ties)."""
    from repro_torch.eval.topk import streaming_topk
    from repro_torch.serving.ann import AnnIndex, ann_topk
    rng = np.random.default_rng(5)
    ue = rng.integers(-2, 3, (300, 64)).astype(np.float32)
    ie = rng.integers(-2, 3, (2000, 64)).astype(np.float32)
    deg = rng.integers(0, 20, 300)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    items = rng.integers(0, 2000, int(indptr[-1])).astype(np.int64)
    kw = dict(seen_indptr=indptr, seen_items=items, user_batch=128,
              item_block=256)
    users = np.arange(0, 300, 3, dtype=np.int32)
    s_p, i_p = streaming_topk(ue, ie, 300, user_ids=users, impl="torch",
                              fused=False, device=dev, **kw)
    before = launch_counts()["fused_topk_score"]
    s_k, i_k = streaming_topk(ue, ie, 300, user_ids=users, device=dev, **kw)
    assert launch_counts()["fused_topk_score"] > before
    np.testing.assert_array_equal(i_k, i_p)
    np.testing.assert_array_equal(s_k, s_p)
    index = AnnIndex(ie, block=32, device=dev)
    before = launch_counts()["fused_topk_score"]
    s_a, i_a = ann_topk(index, ue, ie, 300, keep_frac=1.0, user_ids=users,
                        **kw)
    assert launch_counts()["fused_topk_score"] > before
    np.testing.assert_array_equal(i_a, i_p)
    np.testing.assert_array_equal(s_a, s_p)


# ------------------------------------------------------ tiered training
def _tiered_pipeline(dev, **kw):
    from repro_torch.data import synth
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    data = synth.generate_bipartite(500, 300, 8000, seed=0)
    cfg = PipelineConfig(arch="lightgcn", embed_dim=64, n_layers=2,
                         target_batch=1024, base_batch=1024, microbatch=512,
                         warmup_epochs=0, memory_topology="h100-hbm-host",
                         **kw)
    return build_pipeline(cfg, data, device=dev)


def test_place_fetch_commit_round_trip_bitwise_on_pinned_stores(dev):
    """Demoted leaves are pinned host tensors between steps; fetch brings
    their bits to the card and commit their updated bits back; 3 steps
    equal the all-device run's bit for bit, and the link bytes are each
    demoted leaf once per direction per step."""
    from repro_torch.optim.optimizers import tree_paths
    fast = _tiered_pipeline(dev)
    slow = _tiered_pipeline(dev, memory_pins={"_embed": "host"})
    assert slow.n_offloaded == 6
    sa, sb = fast.init_state(), slow.init_state()
    demoted = {n for n, t in tree_paths({"params": sb["params"],
                                         "opt": sb["opt"]})
               if not t.is_cuda}
    assert len(demoted) == 6
    for (p, a), (_, b) in zip(tree_paths(sa), tree_paths(sb)):
        assert torch.equal(a.cpu(), b.cpu()), p
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_paths(sb) if not t.is_cuda)
    assert all(t.is_pinned() for _, t in tree_paths(sb) if not t.is_cuda)
    fetched = slow.executor.fetch(sb)
    assert all(t.is_cuda for _, t in tree_paths(fetched))
    slow.executor.link_bytes = {"h2d": 0, "d2h": 0}
    for step in range(3):
        sa, la = fast.step_fn(sa, step)
        sb, lb = slow.step_fn(sb, step)
        assert la == lb
    assert slow.executor.link_bytes == {"h2d": 3 * nbytes, "d2h": 3 * nbytes}
    for (p, a), (_, b) in zip(tree_paths(sa), tree_paths(sb)):
        assert b.is_cuda == a.is_cuda or b.is_pinned(), p
        assert torch.equal(a.cpu(), b.cpu()), p


def test_demoted_bytes_leave_the_card_between_steps(dev):
    """Between steps the demoted tables and their Adam moments are off
    the card: memory allocated drops by at least 90 % of their bytes."""
    def between(pipe):
        state = pipe.init_state()
        state, _ = pipe.step_fn(state, 0)
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        demoted = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state) if not t.is_cuda)
        del state
        return held, demoted

    fast, _ = between(_tiered_pipeline(dev))
    torch.cuda.empty_cache()
    slow, demoted = between(_tiered_pipeline(
        dev, memory_pins={"_embed": "host"}))
    assert demoted > 0 and fast - slow >= 0.9 * demoted, (fast, slow,
                                                           demoted)


def test_int8_row_quantizer_on_card_equals_numpy(dev):
    """The device quantizer of the int8 store against the numpy one the
    reference uses, bit for bit: random rows, all-zero rows, maxima that
    are multiples of 127, values halfway between two quanta."""
    from repro_torch.optim.compression import (quantize_rows_int8,
                                               quantize_rows_int8_tensor)
    rng = np.random.default_rng(0)
    table = rng.standard_normal((4096, 128)).astype(np.float32)
    table[0] = 0.0
    table[1, :4] = [127 * 3, 1.5 * 3, 2.5 * 3, -0.5 * 3]
    table[1, 4:] = 0.0
    for r in range(2, 66):
        m = np.float32(rng.uniform(0.1, 100.0))
        scale = np.float32(m / np.float32(127.0) + np.float32(1e-12))
        table[r, 0] = m
        table[r, 1:] = (rng.integers(-126, 126, 127) + 0.5) \
            .astype(np.float32) * scale
    q, scale = quantize_rows_int8(table)
    tq, tscale = quantize_rows_int8_tensor(torch.from_numpy(table).to(dev))
    np.testing.assert_array_equal(tq.cpu().numpy(), q)
    np.testing.assert_array_equal(tscale.cpu().numpy().view(np.int32),
                                  scale.view(np.int32))


@pytest.mark.parametrize("case", NAN_CASES)
def test_fused_topk_kernel_matches_plain_on_nan(dev, case):
    """±NaN of two payloads and ±inf among finite rows: the kernel orders
    scores by IEEE total order, as the plain version does (which
    ``tests/test_torch_topk_nan.py`` holds to the reference on the CPU);
    ids and score bits equal."""
    ue, ie, seen, mask, k, n = fused_case(case, np.random.default_rng(3))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (ue, ie, seen, mask)]
    for blk in (7, 40):
        s_k, i_k = ops.fused_topk_score(*args, k=k, n_items=n,
                                        item_block=blk, impl="cuda")
        s_p, i_p = ref.fused_topk_score_ref(*args, k=k, n_items=n,
                                            item_block=blk)
        assert torch.equal(i_k, i_p)
        assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))



def _intent_close(got, want, abs_sum, integer):
    """Bitwise on integer-valued inputs (every order of adds is exact);
    else |err| <= 1e-5 + 1e-5 x the sum of |terms| (float32 sums in
    another order than the plain version's)."""
    if integer:
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs() <= 1e-5 + 1e-5 * abs_sum).all())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("d,k", [(64, 4), (128, 4), (16, 4), (8, 2), (12, 3)])
def test_intent_kernels_match_plain(dev, d, k, integer):
    """DGCF's ``intent_spmm`` and ``intent_sddmm`` libraries against their
    plain versions on a CSR with empty rows: float4 lanes (D/K a multiple
    of 4) and float lanes, D = 64 with K = 4 the cell's; one launch per
    call, two calls bitwise; D = 12, K = 3 is refused by intent_sddmm's
    lanes (D/K not a power of two)."""
    rng = np.random.default_rng(d + k + integer)
    n_src, n, e = 400, 300, 3000
    dst = rng.integers(0, n // 2, e).astype(np.int32)
    indptr, src, _ = build_csr_by_dst(dst, rng.integers(0, n_src, e), n)
    ip = torch.from_numpy(indptr).to(dev, torch.int64)
    s = torch.from_numpy(src).to(dev)

    def feats(*shape):
        a = rng.integers(-3, 4, shape) if integer \
            else rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    w, x, a = feats(e, k), feats(n_src, d), feats(n, d)
    before = launch_counts()["intent_spmm"]
    got = ops.intent_spmm(w, x, ip, s, n)
    assert launch_counts()["intent_spmm"] == before + 1
    assert torch.equal(got, ops.intent_spmm(w, x, ip, s, n))
    _intent_close(got, ref.intent_spmm_ref(w, x, ip, s, n),
                  ref.intent_spmm_ref(w.abs(), x.abs(), ip, s, n), integer)
    assert bool((got[n // 2:] == 0).all())           # rows with no edge
    if d == 12:
        with pytest.raises(ValueError, match="power of two"):
            ops.intent_sddmm(a, x, ip, s, k)
        return
    before = launch_counts()["intent_sddmm"]
    got = ops.intent_sddmm(a, x, ip, s, k)
    assert launch_counts()["intent_sddmm"] == before + 1
    assert torch.equal(got, ops.intent_sddmm(a, x, ip, s, k))
    _intent_close(got, ref.intent_sddmm_ref(a, x, ip, s, k),
                  ref.intent_sddmm_ref(a.abs(), x.abs(), ip, s, k), integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", ["long_row", "boundaries", "no_edges",
                                  "long_indptr"])
def test_intent_kernels_split_long_rows(dev, case, integer):
    """The merge-path split of both intent kernels on the split graphs (a
    Zipf row of 120,000 edges over ~117 chunks, rows of T - 1, T and T + 1
    edges, a row on a chunk boundary, trailing empty rows, E = 0, an
    over-long indptr), D = 64, K = 4."""
    from repro_torch.kernels.intent import CHUNK
    rng = np.random.default_rng(len(case) + 7 * integer)
    indptr, n, src = _split_graph(case, CHUNK, rng)

    def feats(*shape):
        a = rng.integers(-3, 4, shape) if integer \
            else rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    ip = torch.from_numpy(indptr).to(dev)
    s = torch.from_numpy(src).to(dev)
    w, x, a = feats(len(src), 4), feats(500, 64), feats(len(indptr) - 1, 64)
    got = ops.intent_spmm(w, x, ip, s, n)
    assert torch.equal(got, ops.intent_spmm(w, x, ip, s, n))
    _intent_close(got, ref.intent_spmm_ref(w, x, ip, s, n),
                  ref.intent_spmm_ref(w.abs(), x.abs(), ip, s, n), integer)
    got = ops.intent_sddmm(a, x, ip, s, 4)
    assert torch.equal(got, ops.intent_sddmm(a, x, ip, s, 4))
    _intent_close(got, ref.intent_sddmm_ref(a, x, ip, s, 4),
                  ref.intent_sddmm_ref(a.abs(), x.abs(), ip, s, 4), integer)


def test_dgcf_step_on_the_card_matches_the_plain_route(dev):
    """One DGCF training step through ``Pipeline.step_fn`` on the kernels
    against the same step on the plain route on the card: the loss within
    1e-5 and each table after Adam within 1e-4 in the norm of its change
    (float32 sums in other orders); both kernels launched."""
    from repro_torch.data import synth
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    data = synth.generate_bipartite(400, 300, 6000, seed=1)
    out = []
    for impl in (None, "torch"):
        cfg = PipelineConfig(arch="dgcf", embed_dim=64, n_layers=1,
                             base_batch=512, target_batch=512, microbatch=512,
                             warmup_epochs=0, impl=impl)
        pipe = build_pipeline(cfg, data, device=dev)
        state0 = pipe.init_state()
        p0 = [t.clone() for t in tree_leaves(state0["params"])]
        before = launch_counts()
        state, loss = pipe.step_fn(state0, 0)
        after = launch_counts()
        out.append((float(loss), p0, tree_leaves(state["params"]),
                    {k: after[k] - before[k]
                     for k in ("intent_spmm", "intent_sddmm")}))
    (lk, p0, pk, nk), (lp, _, pp, np_) = out
    assert nk["intent_spmm"] > 0 and nk["intent_sddmm"] > 0
    assert np_ == {"intent_spmm": 0, "intent_sddmm": 0}
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b, z in zip(pk, pp, p0):
        assert float((a - b).norm() / (b - z).norm()) <= 1e-4

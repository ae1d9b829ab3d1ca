"""The edge groups behind the ``sddmm`` kernel, on the CPU.

The CUDA kernel (``csrc/sddmm.cu``) walks a COO graph's edges grouped by
one endpoint, the key (``kernels/sddmm.py:EdgeGroups``, built once per
graph by ``BipartiteGraph.user_groups``): one warp per chunk of ``CHUNK``
sorted positions, 32 positions' indices at a time, ``UNROLL`` edges in
flight, and the key's row loaded only where the key changes from the
previous live edge.  ``replay`` runs that walk in numpy: the row it holds
is a copy taken at each load, so a stale row would show in the values.
It is held to the port's plain version (``ref.sddmm_ref``): bitwise on
integer-valued inputs for all four ops, bitwise for 'mul'/'add'/'copy' on
floats (one rounding per element) and 'dot' within 1e-5 (its sum runs in
the kernel's lane order: four products per lane, lanes' partials by
column, then the xor tree).  Each output row is written exactly once,
masked rows are +0.0 and load no row, and the key's row is loaded at most
(distinct keys + chunks) times.  Then: the groups are built once per
graph; ``ops.sddmm`` with groups equals the call without, forward and
backward; NGCF O1-O3 with the groups in play equal the reference's
levels; and groups of another call are refused."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import message_passing as jmp
from repro.data import synth as jsynth
from repro_torch.core import graph, message_passing, ngcf
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sddmm as ksddmm
from repro_torch.kernels.sddmm import (CHUNK, UNROLL, group_edges,
                                       grouped_operands)

T = torch.from_numpy
OPS = ["mul", "add", "dot", "copy"]
TOL = dict(rtol=1e-5, atol=1e-5)     # 'dot': fp32 sums in another order
LONG_GROUP = 4 * CHUNK + 57          # one user's edges: live, past three
WIDTH = {16: 1, 64: 37, CHUNK: 12}   # D per chunk: scalar and float4 lanes
CSRC = pathlib.Path(ksddmm.__file__).resolve().parent / "csrc" / "sddmm.cu"


def _case(seed, d, integer, keyed):
    """A random bipartite graph: 40 users x 30 items, user 7 holding
    LONG_GROUP edges, ~20 % of the real edges masked in the middle and 23
    masked padding edges at the end (user 0, item 0, as ``pad_edges``
    makes them); tables of 40 and 30 rows.  keyed='src': the call's src
    are the users (the O3 call); keyed='dst': its dst are (O2's second
    call).  Returns the call's (x, y, src, dst, mask, coeff) as numpy."""
    rng = np.random.default_rng(seed)
    n_users, n_items = 40, 30
    e_real, e_pad = LONG_GROUP + 600, LONG_GROUP + 623
    user = rng.integers(0, n_users, e_real).astype(np.int32)
    user[rng.permutation(e_real)[:LONG_GROUP]] = 7
    item = rng.integers(0, n_items, e_real).astype(np.int32)
    u, i, mask = graph.pad_edges(user, item, e_pad)
    mask[:e_real] &= rng.random(e_real) > 0.2

    def feats(*shape):
        if integer:
            return rng.integers(-3, 4, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    xu, xi, coeff = feats(n_users, d), feats(n_items, d), feats(e_pad)
    call = (xu, xi, u, i) if keyed == "src" else (xi, xu, i, u)
    return (*call, mask, coeff)


def _tensors(case):
    x, y, src, dst, mask, coeff = (T(a) for a in case)
    return x, y, src, dst, mask, coeff, group_edges(src, dst, mask)


def _dot_lane_order(a, b):
    """<a, b> as the kernel sums it: lanes of 4 floats (1 when D % 4),
    each lane's products summed left to right, lane columns added to
    their lane's partial in column order from +0.0, then the xor tree."""
    per = 4 if a.size % 4 == 0 else 1
    prods = (a * b).reshape(-1, per)
    col = prods[:, 0].copy()
    for k in range(1, per):
        col = (col + prods[:, k]).astype(np.float32)
    lanes = np.zeros(32, np.float32)
    for c, v in enumerate(col):
        lanes[c % 32] = np.float32(lanes[c % 32] + v)
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[idx ^ off]).astype(np.float32)
    return lanes[0]


def replay(op, g_tab, o_tab, perm, key, other, live, coeff, keyed, chunk):
    """The kernel's walk over (perm, key, other, live), in numpy: returns
    (out, writes per edge, key-row loads).  g_tab is the table the key
    indexes, o_tab the other; a masked position loads no row."""
    e, d = perm.size, g_tab.shape[1]
    out = np.full((e,) if op == "dot" else (e, d), np.nan, np.float32)
    writes = np.zeros(e, np.int64)
    loads = 0
    for begin in range(0, e, chunk):
        end = min(begin + chunk, e)
        cur, held = -1, np.zeros(d, np.float32)
        for base in range(begin, end, 32):
            cnt = min(32, end - base)
            for j0 in range(0, cnt, UNROLL):
                pos = [base + j0 + q for q in range(UNROLL)]
                valid = [j0 + q < cnt for q in range(UNROLL)]
                lv, fresh = [], []
                for p, ok in zip(pos, valid):
                    alive = ok and bool(live[p])
                    lv.append(alive)
                    fresh.append(alive and key[p] != cur)
                    if alive:
                        cur = key[p]
                rows = [None] * UNROLL
                for q, p in enumerate(pos):          # loads first
                    if fresh[q]:
                        rows[q] = g_tab[key[p]].copy()
                        loads += 1
                for q in range(UNROLL):              # then the held rows
                    if not fresh[q]:
                        rows[q] = held if q == 0 else rows[q - 1]
                held = rows[-1]
                for q, p in enumerate(pos):
                    if not valid[q]:
                        continue
                    edge = perm[p]
                    writes[edge] += 1
                    if not lv[q]:
                        out[edge] = 0.0
                        continue
                    a = rows[q]
                    b = o_tab[other[p]]
                    xr, yr = (a, b) if keyed == "src" else (b, a)
                    if op == "mul":
                        out[edge] = xr * yr
                    elif op == "add":
                        out[edge] = xr + yr
                    elif op == "dot":
                        out[edge] = _dot_lane_order(xr, yr)
                    else:
                        out[edge] = a * coeff[edge] if coeff is not None \
                            else a
    return out, writes, loads


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("keyed", ["src", "dst"])
@pytest.mark.parametrize("chunk", [16, 64, CHUNK])
@pytest.mark.parametrize("op", OPS)
def test_replayed_walk_matches_plain(op, chunk, keyed, integer):
    case = _case(chunk + len(op), WIDTH[chunk], integer, keyed)
    x, y, src, dst, mask, coeff, _ = _tensors(case)
    key_t = src if keyed == "src" else dst
    other_t = dst if keyed == "src" else src
    groups = group_edges(key_t, other_t, mask)
    if op == "copy" and keyed == "dst":      # copy reads x[src] alone
        with pytest.raises(ValueError, match="do not belong to this call"):
            grouped_operands(groups, op, x, y, src, dst, mask)
        return
    g_tab, o_tab = grouped_operands(groups, op, x, y, src, dst, mask)
    assert g_tab is (x if keyed == "src" else y)
    c = coeff if op == "copy" else None
    got, writes, loads = replay(
        op, g_tab.numpy(), o_tab.numpy(), groups.perm.numpy(),
        groups.key_sorted.numpy(), groups.other_sorted.numpy(),
        groups.mask_sorted.numpy(), None if c is None else c.numpy(), keyed,
        chunk)
    want = ref.sddmm_ref(op, x, y, src, dst, mask, c).numpy()
    np.testing.assert_array_equal(writes, 1)             # each row once
    dead = ~mask.numpy()
    np.testing.assert_array_equal(got[dead], 0.0)
    assert not np.signbit(got[dead]).any()                # +0.0
    live_keys = np.unique(key_t.numpy()[~dead])
    n_chunks = -(-src.numel() // chunk)
    assert loads <= live_keys.size + n_chunks
    assert np.bincount(key_t.numpy()[~dead]).max() > 3 * chunk
    if op == "dot" and not integer:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_group_edges_layout():
    """A stable sort by key: keys non-decreasing, edge ids rising inside
    each group, the other index and the mask carried along; padding edges
    (masked, user 0) land in user 0's group."""
    x, y, src, dst, mask, _, groups = _tensors(_case(1, 4, True, "src"))
    perm = groups.perm.numpy()
    assert groups.perm.dtype == groups.key_sorted.dtype == torch.int32
    assert groups.mask_sorted.dtype == torch.uint8
    np.testing.assert_array_equal(np.sort(perm), np.arange(src.numel()))
    np.testing.assert_array_equal(perm, np.argsort(src.numpy(),
                                                   kind="stable"))
    np.testing.assert_array_equal(groups.key_sorted.numpy(), src.numpy()[perm])
    np.testing.assert_array_equal(groups.other_sorted.numpy(),
                                  dst.numpy()[perm])
    np.testing.assert_array_equal(groups.mask_sorted.numpy(),
                                  mask.numpy()[perm])
    pads = np.flatnonzero(~mask.numpy())[-23:]
    assert set(pads) <= set(perm[groups.key_sorted.numpy() == 0])


def test_kernel_constants_match_the_source():
    """CHUNK and UNROLL, which the replay uses, are the kernel's."""
    text = CSRC.read_text()
    assert re.search(rf"constexpr int kChunk = {CHUNK};", text)
    assert re.search(rf"constexpr int kUnroll = {UNROLL};", text)


def test_groups_are_built_once_per_graph():
    """Every level, layer and backward of one graph reuses one build; a
    new graph object builds its own."""
    data = jsynth.generate_bipartite(50, 40, 500, seed=2)
    g = graph.bipartite_from_numpy(data.user, data.item, 50, 40,
                                   data.n_edges + 9, device="cpu")
    p = ngcf.init_params(2, 50, 40, 8, 3, device="cpu")
    before = group_edges.builds
    for level in (1, 2, 3):
        ngcf.forward(p, g, opt_level=level)
    q = {k: (v.requires_grad_(True) if torch.is_tensor(v) else
             [w.requires_grad_(True) for w in v]) for k, v in p.items()}
    sum(t.sum() for t in ngcf.forward(q, g, opt_level=3)).backward()
    assert group_edges.builds == before + 1
    assert g.user_groups() is g.user_groups()
    g2 = graph.bipartite_from_numpy(data.user, data.item, 50, 40,
                                    device="cpu")
    ngcf.forward(p, g2, opt_level=3)
    assert group_edges.builds == before + 2


@pytest.mark.parametrize("keyed", ["src", "dst"])
@pytest.mark.parametrize("op", OPS)
def test_ops_sddmm_with_groups_equals_without(op, keyed):
    """The plain route ignores the groups: forward and backward equal."""
    if op == "copy":
        keyed = "src"
    x, y, src, dst, mask, coeff, _ = _tensors(_case(5, 10, False, keyed))
    key_t, other_t = (src, dst) if keyed == "src" else (dst, src)
    groups = group_edges(key_t, other_t, mask)
    outs, grads = [], []
    for grp in (None, groups):
        xt = x.clone().requires_grad_(True)
        yt = y.clone().requires_grad_(True)
        ct = coeff.clone().requires_grad_(True) if op == "copy" else None
        out = ops.sddmm(op, xt, yt, src, dst, mask, ct, groups=grp)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum() \
            .backward()
        outs.append(out.detach())
        grads.append([t.grad for t in (xt, yt, ct) if t is not None
                      and t.grad is not None])
    assert torch.equal(outs[0], outs[1])
    assert len(grads[0]) == len(grads[1]) > 0
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_grouped_operands_refuses_foreign_groups():
    """Groups are taken only with the indices and mask they were built
    from: another graph's (equal values, other storage), a swapped key,
    another mask, and dst-keyed groups for 'copy' raise."""
    x, y, src, dst, mask, _, groups = _tensors(_case(3, 8, True, "src"))
    assert grouped_operands(groups, "mul", x, y, src, dst, mask) == (x, y)
    assert grouped_operands(groups, "dot", y, x, dst, src, mask) == (x, y)
    foreign = group_edges(src.clone(), dst.clone(), mask)
    with pytest.raises(ValueError, match="do not belong to this call"):
        grouped_operands(foreign, "mul", x, y, src, dst, mask)
    with pytest.raises(ValueError, match="do not belong to this call"):
        grouped_operands(groups, "mul", x, y, src, src, mask)
    with pytest.raises(ValueError, match="another edge mask"):
        grouped_operands(groups, "mul", x, y, src, dst, mask.clone())
    with pytest.raises(ValueError, match="do not belong to this call"):
        grouped_operands(groups, "copy", y, x, dst, src, mask)
    assert grouped_operands(groups, "copy", x, y, src, dst, mask) == (x, y)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_ngcf_levels_with_groups_match_reference(level):
    """NGCF layers at O1-O3 hand the graph's user groups to every sddmm
    call and still equal the reference's level (fp32, another sum
    order); integer-valued inputs bitwise."""
    data = jsynth.generate_bipartite(60, 45, 600, seed=4)
    train, _ = jsynth.train_test_split(data)
    e_pad = train.n_edges + 13
    jg = jgraph.bipartite_from_numpy(train.user, train.item, 60, 45, e_pad)
    g = graph.bipartite_from_numpy(train.user, train.item, 60, 45, e_pad,
                                   device="cpu")
    rng = np.random.default_rng(level)
    for integer in (False, True):
        def feats(*shape):
            if integer:
                return rng.integers(-2, 3, shape).astype(np.float32)
            return (rng.standard_normal(shape) * 0.3).astype(np.float32)
        args = (feats(60, 16), feats(45, 16), feats(16, 16), feats(16, 16))
        want = jmp.ngcf_propagate_bipartite(jg, *map(jnp.asarray, args),
                                            opt_level=level)
        got = message_passing.ngcf_propagate_bipartite(
            g, *map(T, args), opt_level=level)
        for a, b in zip(got, want):
            if integer:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert g._user_groups is not None

"""The port's ``hadamard_spmm`` and the graph's autograd Functions on the
CPU: the plain versions against the reference's XLA oracle and its Pallas
kernel in interpret mode (the adversarial shapes of
tests/test_kernel_parity.py), each structured route against
``hadamard_spmm_xla``, and every custom backward against torch autograd
of the plain composition and against the reference's custom-VJP
gradients on the same inputs.  The CUDA kernel runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.hadamard_spmm import hadamard_spmm_pallas, hadamard_spmm_xla
from repro.pipeline.sparse import BipartiteCSR as JBipartiteCSR
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels.hadamard_spmm import (hadamard_spmm_cuda,
                                               hadamard_spmm_plain)
from repro_torch.pipeline import BipartiteCSR

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order


def _case(seed, n_src, n_dst, e, integer=False):
    """dst-sorted CSR + per-edge (x_idx, y_idx); edges land on a strict
    subset of destinations so empty rows exist."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, max(n_dst // 2, 1), e)).astype(np.int32)
    indptr = np.searchsorted(dst, np.arange(n_dst + 1)).astype(np.int32)
    x_idx = rng.integers(0, n_src, e).astype(np.int32)
    y_idx = rng.integers(0, n_dst, e).astype(np.int32)

    def feats(n, d):
        if integer:
            return rng.integers(-3, 4, (n, d)).astype(np.float32)
        return rng.standard_normal((n, d)).astype(np.float32)

    return indptr, x_idx, y_idx, dst, feats


def _port(x, y, indptr, x_idx, y_idx, n, **kw):
    return ops.hadamard_spmm(T(x), T(y), T(indptr).long(), T(x_idx), T(y_idx),
                             n, **kw)


def _jax(fn, x, y, indptr, x_idx, y_idx, n, **kw):
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(indptr),
                         jnp.asarray(x_idx), jnp.asarray(y_idx), n, **kw))


@pytest.mark.parametrize("n_src,n_dst,e,d,rb", [
    (9, 7, 30, 100, 4),    # D % 128 != 0, n_dst % row_block != 0
    (13, 11, 21, 37, 8),   # everything ragged
    (6, 5, 1, 130, 4),     # single edge, D just over one lane tile
    (8, 6, 0, 16, 4),      # zero edges: all rows empty
])
def test_hadamard_ref_matches_reference_and_pallas(n_src, n_dst, e, d, rb):
    indptr, x_idx, y_idx, _, feats = _case(n_src * 1000 + e, n_src, n_dst, e)
    x, y = feats(n_src, d), feats(n_dst, d)
    got = _port(x, y, indptr, x_idx, y_idx, n_dst).numpy()
    np.testing.assert_allclose(
        got, _jax(jref.hadamard_spmm_ref, x, y, indptr, x_idx, y_idx, n_dst),
        **TOL)
    np.testing.assert_allclose(
        got, _jax(hadamard_spmm_pallas, x, y, indptr, x_idx, y_idx, n_dst,
                  row_block=rb, interpret=True), **TOL)
    empty = np.diff(indptr) == 0
    assert empty.any()
    np.testing.assert_array_equal(got[empty], 0.0)


def test_hadamard_ref_integer_inputs_are_exact():
    """Integer-valued rows: the summation order cannot matter, so the
    port equals both the oracle and the Pallas kernel bit for bit."""
    indptr, x_idx, y_idx, _, feats = _case(7, 12, 9, 40, integer=True)
    x, y = feats(12, 24), feats(9, 24)
    got = _port(x, y, indptr, x_idx, y_idx, 9).numpy()
    np.testing.assert_array_equal(
        got, _jax(jref.hadamard_spmm_ref, x, y, indptr, x_idx, y_idx, 9))
    np.testing.assert_array_equal(
        got, _jax(hadamard_spmm_pallas, x, y, indptr, x_idx, y_idx, 9,
                  row_block=4, interpret=True))


def test_hadamard_ref_epilogue_scale_and_leaky_relu():
    n_src, n_dst, e, d = 10, 8, 25, 36
    indptr, x_idx, y_idx, _, feats = _case(11, n_src, n_dst, e)
    x, y = feats(n_src, d), feats(n_dst, d)
    scale = np.random.default_rng(12).standard_normal(n_dst).astype(np.float32)
    got = _port(x, y, indptr, x_idx, y_idx, n_dst, scale=T(scale),
                slope=0.2).numpy()
    kw = dict(scale=jnp.asarray(scale), slope=0.2)
    np.testing.assert_allclose(
        got, _jax(jref.hadamard_spmm_ref, x, y, indptr, x_idx, y_idx, n_dst,
                  **kw), **TOL)
    np.testing.assert_allclose(
        got, _jax(hadamard_spmm_pallas, x, y, indptr, x_idx, y_idx, n_dst,
                  row_block=4, interpret=True, **kw), **TOL)
    assert (got < 0).any()                 # the negative branch was taken


@pytest.mark.parametrize("structure", ["general", "y_is_dst", "x_eq_y"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_structured_routes_match_reference(structure, epilogue):
    """Each structured route against ``hadamard_spmm_xla``'s, with the
    asserted structure holding, and against the general oracle."""
    n_src, n_dst, e, d = 9, 7, 28, 20
    indptr, x_idx, y_idx, dst, feats = _case(13, n_src, n_dst, e)
    if structure == "y_is_dst":
        y_idx, n_y = dst.copy(), n_dst          # y rides the destination
    elif structure == "x_eq_y":
        y_idx, n_y = x_idx.copy(), n_src        # both gathers share an index
    else:
        n_y = n_dst
    x, y = feats(n_src, d), feats(n_y, d)
    scale = np.linspace(-1, 2, n_dst).astype(np.float32)
    kw = dict(scale=T(scale), slope=0.2) if epilogue else {}
    jkw = dict(scale=jnp.asarray(scale), slope=0.2) if epilogue else {}
    got = hadamard_spmm_plain(T(x), T(y), T(indptr).long(), T(x_idx),
                              T(y_idx), n_dst, structure=structure, **kw)
    want = _jax(hadamard_spmm_xla, x, y, indptr, x_idx, y_idx, n_dst,
                structure=structure, **jkw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    general = _port(x, y, indptr, x_idx, y_idx, n_dst, **kw)
    np.testing.assert_allclose(got.numpy(), general.numpy(), **TOL)


def test_bad_structure_raises_on_both_routes():
    args = (torch.zeros(2, 3), torch.zeros(2, 3),
            torch.zeros(3, dtype=torch.long), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="structure"):
        hadamard_spmm_plain(*args, structure="nope")
    for impl in (None, "torch", "cuda"):
        with pytest.raises(ValueError, match="structure"):
            ops.hadamard_spmm(*args, structure="nope", impl=impl)


def test_hadamard_dispatch_on_cpu_tensors():
    """A CPU tensor takes the plain version and launches nothing;
    impl='cuda' on it raises, and so does the kernel's wrapper."""
    indptr, x_idx, y_idx, _, feats = _case(17, 8, 6, 20)
    x, y = feats(8, 12), feats(6, 12)
    before = launch_counts()
    assert "hadamard_spmm" in before
    a = _port(x, y, indptr, x_idx, y_idx, 6)
    b = _port(x, y, indptr, x_idx, y_idx, 6, impl="torch")
    assert launch_counts() == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        _port(x, y, indptr, x_idx, y_idx, 6, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        hadamard_spmm_cuda(T(x), T(y), T(indptr).long(), T(x_idx), T(y_idx), 6)


# ------------------------------------------------------- graph and autograd
def _graph(seed=4, nu=9, ni=8, e=26, hadamard="auto"):
    rng = np.random.default_rng(seed)
    user = rng.integers(0, nu, e).astype(np.int32)
    item = rng.integers(0, ni, e).astype(np.int32)
    jg = JBipartiteCSR(user, item, nu, ni, impl="xla", hadamard=hadamard)
    tg = BipartiteCSR(user, item, nu, ni, device="cpu", hadamard=hadamard)
    return rng, jg, tg


def test_graph_edge_orders_match_reference():
    _, jg, tg = _graph()
    for name in ("ui_indptr", "ui_src", "ui_dst", "iu_indptr", "iu_src",
                 "iu_dst", "perm_ui_to_iu"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert tg.ui_dst.dtype == tg.perm_ui_to_iu.dtype == torch.int32


@pytest.mark.parametrize("hadamard,fused", [("auto", True), ("fused", True),
                                            ("composed", False)])
def test_hadamard_knob(hadamard, fused):
    _, jg, tg = _graph(hadamard=hadamard)
    assert tg.fused_hadamard is fused is jg.fused_hadamard


def test_hadamard_knob_and_ring_raise():
    """An unknown route raises; the ring dispatch builds and, as the
    reference's, takes NGCF's composed route (its rotation schedule has
    no fused gather-multiply-aggregate)."""
    user = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="hadamard must be"):
        BipartiteCSR(user, user, 2, 2, device="cpu", hadamard="nope")
    g = BipartiteCSR(user, user, 2, 2, device="cpu", impl="ring")
    jg = JBipartiteCSR(user, user, 2, 2, impl="ring")
    assert g.fused_hadamard is jg.fused_hadamard is False
    assert g.spmm == jg.spmm == "ring"


def _aggs(tg, jg, ni, nu):
    """(name, port op, reference op, plain autograd composition, shapes)."""
    src, dst = tg.ui_src.long(), tg.ui_dst.long()
    isrc, idst = tg.iu_src.long(), tg.iu_dst.long()

    def seg(m, index, n):
        return torch.zeros((n, m.shape[1])).index_add_(0, index, m)

    return {
        "agg_u2i": (tg.agg_u2i, jg.agg_u2i,
                    lambda x: seg(x[src], dst, ni), [(nu,)]),
        "agg_i2u": (tg.agg_i2u, jg.agg_i2u,
                    lambda x: seg(x[isrc], idst, nu), [(ni,)]),
        "edge_agg_item": (tg.edge_agg_item, jg.edge_agg_item,
                          lambda m: seg(m, dst, ni), [(tg.n_edges,)]),
        "edge_agg_user": (tg.edge_agg_user, jg.edge_agg_user,
                          lambda m: seg(m, idst, nu), [(tg.n_edges,)]),
        "hadamard_agg_item": (tg.hadamard_agg_item, jg.hadamard_agg_item,
                              lambda xu, xi: seg(xu[src] * xi[dst], dst, ni),
                              [(nu,), (ni,)]),
        "hadamard_agg_user": (tg.hadamard_agg_user, jg.hadamard_agg_user,
                              lambda xi, xu: seg(xi[isrc] * xu[idst], idst, nu),
                              [(ni,), (nu,)]),
    }


@pytest.mark.parametrize("name", ["agg_u2i", "agg_i2u", "edge_agg_item",
                                  "edge_agg_user", "hadamard_agg_item",
                                  "hadamard_agg_user"])
def test_custom_backward_matches_autograd_and_reference(name):
    """Forward and every input's gradient of sum(sin(op(...))): the
    port's Function against torch autograd of the plain composition, and
    against jax.grad through the reference's custom VJP."""
    nu, ni, d = 9, 8, 5
    rng, jg, tg = _graph(nu=nu, ni=ni)
    op, jop, plain, shapes = _aggs(tg, jg, ni, nu)[name]
    xs = [rng.standard_normal((s[0], d)).astype(np.float32) for s in shapes]
    ins = [T(x).requires_grad_(True) for x in xs]
    out = op(*ins)
    grads = torch.autograd.grad(torch.sin(out).sum(), ins)
    ref_ins = [T(x).requires_grad_(True) for x in xs]
    ref_out = plain(*ref_ins)
    ref_grads = torch.autograd.grad(torch.sin(ref_out).sum(), ref_ins)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-6)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)

    def jloss(*a):
        return jnp.sum(jnp.sin(jop(*a)))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jop(*[jnp.asarray(x) for x in xs])),
                               rtol=1e-5, atol=1e-6)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def test_hadamard_backward_calls_only_needed_cotangents(monkeypatch):
    """Forward is one call; the backward makes one call per operand that
    needs a gradient (``needs_input_grad``), with the reference's
    structures: x_eq_y over the reverse CSR, y_is_dst over the forward."""
    from repro_torch.pipeline import sparse
    calls = []
    real = sparse.kops.hadamard_spmm

    def spy(*a, structure, **kw):
        calls.append((structure, a[2] is tg.ui_indptr))
        return real(*a, structure=structure, **kw)

    monkeypatch.setattr(sparse.kops, "hadamard_spmm", spy)
    rng, _, tg = _graph()
    xu = T(rng.standard_normal((9, 4)).astype(np.float32)).requires_grad_(True)
    xi = T(rng.standard_normal((8, 4)).astype(np.float32))
    out = tg.hadamard_agg_item(xu, xi)
    torch.autograd.grad(out.sum(), [xu])
    assert calls == [("y_is_dst", True), ("x_eq_y", False)]
    xi.requires_grad_(True)
    calls.clear()
    torch.autograd.grad(tg.hadamard_agg_item(xu, xi).sum(), [xu, xi])
    assert calls == [("y_is_dst", True), ("x_eq_y", False), ("y_is_dst", True)]

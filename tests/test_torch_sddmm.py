"""The port's ``sddmm`` on the CPU: the plain version against the
reference's oracle (``repro.kernels.ref.sddmm_ref``) and its Pallas kernel
in interpret mode, as tests/test_kernels.py runs it, for all four ops,
masked and unmasked, with coeff None and given; routing; and the autograd
Function's written-out backward against ``jax.grad`` of the reference's
``sparse_ops.sddmm`` and ``ref.sddmm_ref``.  The CUDA kernel runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_ops as jsparse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sddmm import sddmm_pallas
from repro_torch.core import sparse_ops
from repro_torch.kernels import WRAPPERS, launch_counts, ops, ref
from repro_torch.kernels.sddmm import sddmm_cuda

T = torch.from_numpy
OPS = ["mul", "add", "dot", "copy"]
TOL = dict(rtol=1e-5, atol=1e-5)     # fp32 sums in another order ('dot')
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, n_x, n_y, e, d, masked=True, integer=False):
    rng = np.random.default_rng(seed)

    def feats(n):
        if integer:
            return rng.integers(-3, 4, (n, d)).astype(np.float32)
        return rng.standard_normal((n, d)).astype(np.float32)

    x, y = feats(n_x), feats(n_y)
    src = rng.integers(0, n_x, e).astype(np.int32)
    dst = rng.integers(0, n_y, e).astype(np.int32)
    mask = rng.random(e) > 0.3 if masked else np.ones(e, bool)
    if masked and e:
        mask[0] = mask[-1] = False
    coeff = (rng.integers(-2, 3, e) if integer
             else rng.standard_normal(e)).astype(np.float32)
    return x, y, src, dst, mask, coeff


def _jax(fn, op, x, y, src, dst, mask, coeff, **kw):
    c = None if coeff is None else jnp.asarray(coeff)
    return np.asarray(fn(op, jnp.asarray(x), jnp.asarray(y), jnp.asarray(src),
                         jnp.asarray(dst), jnp.asarray(mask), c, **kw))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("with_coeff", [True, False])
@pytest.mark.parametrize("n_x,n_y,e,d", [(16, 9, 33, 8), (7, 13, 20, 37),
                                         (5, 5, 1, 130)])
def test_sddmm_ref_matches_reference_and_pallas(op, masked, with_coeff, n_x,
                                                n_y, e, d):
    x, y, src, dst, mask, coeff = _case(n_x * 100 + e + d, n_x, n_y, e, d,
                                        masked)
    c = coeff if with_coeff else None
    got = ref.sddmm_ref(op, T(x), T(y), T(src), T(dst), T(mask),
                        None if c is None else T(c)).numpy()
    want = _jax(jref.sddmm_ref, op, x, y, src, dst, mask, c)
    assert got.shape == want.shape == ((e,) if op == "dot" else (e, d))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, _jax(sddmm_pallas, op, x, y, src, dst, mask, c, edge_block=8,
                  interpret=True), **TOL)
    if op != "dot":      # one rounding per element: bitwise on any input
        np.testing.assert_array_equal(got, want)
    dead = ~mask
    np.testing.assert_array_equal(got[dead], 0.0)
    assert not np.signbit(got[dead]).any()          # +0.0, never -0.0


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("with_coeff", [True, False])
def test_sddmm_integer_inputs_are_bitwise(op, with_coeff):
    """Integer-valued rows: 'dot' sums stay exact too, so the plain
    version equals the oracle and the Pallas kernel bit for bit."""
    x, y, src, dst, mask, coeff = _case(3, 12, 9, 40, 24, integer=True)
    c = coeff if with_coeff else None
    got = ops.sddmm(op, T(x), T(y), T(src), T(dst), T(mask),
                    None if c is None else T(c)).numpy()
    np.testing.assert_array_equal(
        got, _jax(jref.sddmm_ref, op, x, y, src, dst, mask, c))
    np.testing.assert_array_equal(
        got, _jax(sddmm_pallas, op, x, y, src, dst, mask, c, edge_block=8,
                  interpret=True))


def test_sddmm_copy_coeff_quirk_of_the_two_entry_points():
    """``ops.sddmm('copy', ..., coeff)`` scales by coeff, while
    ``sparse_ops.sddmm('copy', ...)`` takes none (reference
    kernels/ops.py:46-52)."""
    x, y, src, dst, mask, coeff = _case(5, 10, 10, 30, 16)
    scaled = ops.sddmm("copy", T(x), T(y), T(src), T(dst), T(mask), T(coeff))
    plain = sparse_ops.sddmm("copy", T(x), T(y), T(src), T(dst), T(mask))
    np.testing.assert_array_equal(
        scaled.numpy(), _jax(jops.sddmm, "copy", x, y, src, dst, mask, coeff))
    j_plain = jsparse.sddmm("copy", jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(mask))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(j_plain))
    assert not torch.equal(scaled, plain)


def test_sddmm_mask_as_integers_and_zero_edges():
    x, y, src, dst, mask, _ = _case(6, 8, 6, 25, 12)
    as_int = ops.sddmm("mul", T(x), T(y), T(src), T(dst),
                       T(mask.astype(np.int32)))
    as_bool = ops.sddmm("mul", T(x), T(y), T(src), T(dst), T(mask))
    assert torch.equal(as_int, as_bool)
    e0 = torch.zeros(0, dtype=torch.int32)
    for op in OPS:
        out = ops.sddmm(op, T(x), T(y), e0, e0, torch.zeros(0, dtype=torch.bool))
        assert out.shape == ((0,) if op == "dot" else (0, 12))


def test_sddmm_routing():
    """impl=None and 'torch' run the plain version on a CPU tensor and
    launch nothing; 'cuda' on a CPU tensor raises, as does the kernel's
    wrapper itself; the wrapper is registered with its counter."""
    x, y, src, dst, mask, _ = _case(7, 6, 6, 10, 8)
    args = [T(a) for a in (x, y, src, dst, mask)]
    before = launch_counts()["sddmm"]
    want = ref.sddmm_ref("mul", *args)
    for impl in (None, "torch"):
        assert torch.equal(ops.sddmm("mul", *args, impl=impl), want)
    assert launch_counts()["sddmm"] == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.sddmm("mul", *args, impl="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sddmm_cuda("mul", *args)
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.sddmm("mul", *args, impl="pallas")
    with pytest.raises(ValueError):
        ops.sddmm("max", *args)
    assert WRAPPERS["sddmm"] is sddmm_cuda


def _port_grads(op, x, y, src, dst, mask, coeff, ct):
    xt = T(x).requires_grad_(True)
    yt = T(y).requires_grad_(True)
    ctt = None if coeff is None else T(coeff).requires_grad_(True)
    out = ops.sddmm(op, xt, yt, T(src), T(dst), T(mask), ctt)
    leaves = [xt] + ([yt] if op != "copy" else []) \
        + ([ctt] if ctt is not None else [])
    grads = torch.autograd.grad((out * T(ct)).sum(), leaves)
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("op", ["mul", "add", "dot"])
@pytest.mark.parametrize("d", [8, 37])
def test_sddmm_backward_matches_jax_grad(op, d):
    """∂x and ∂y of <sddmm(op), ct> against jax.grad of the reference's
    XLA route (``sparse_ops.sddmm``); masked edges carry no gradient."""
    x, y, src, dst, mask, _ = _case(11 + d, 9, 7, 60, d)
    rng = np.random.default_rng(d)
    ct = rng.standard_normal((60,) if op == "dot" else (60, d)).astype(
        np.float32)

    def loss(xx, yy):
        m = jsparse.sddmm(op, xx, yy, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(mask))
        return jnp.sum(m * jnp.asarray(ct))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    got = _port_grads(op, x, y, src, dst, mask, None, ct)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("with_coeff", [True, False])
def test_sddmm_copy_backward_matches_jax_grad(with_coeff):
    """'copy': ∂x = Σ coeff·g and ∂coeff = Σ_D g ⊙ x[src], against jax.grad
    of the reference's ``ref.sddmm_ref`` (the route that takes coeff)."""
    x, y, src, dst, mask, coeff = _case(13, 9, 7, 60, 16)
    c = coeff if with_coeff else None
    ct = np.random.default_rng(1).standard_normal((60, 16)).astype(np.float32)

    def loss(xx, cc):
        m = jref.sddmm_ref("copy", xx, jnp.asarray(y), jnp.asarray(src),
                           jnp.asarray(dst), jnp.asarray(mask), cc)
        return jnp.sum(m * jnp.asarray(ct))

    if with_coeff:
        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(c))
    else:
        want = (jax.grad(loss)(jnp.asarray(x), None),)
    got = _port_grads("copy", x, y, src, dst, mask, c, ct)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)
    # masked edges: zero coefficient gradient
    if with_coeff:
        np.testing.assert_array_equal(got[1][~mask], 0.0)


def test_sddmm_backward_integer_inputs_are_exact():
    """Integer-valued inputs and cotangents: every gradient sum is exact,
    so the written-out backward equals jax.grad bit for bit."""
    x, y, src, dst, mask, _ = _case(17, 9, 7, 50, 12, integer=True)
    ct = np.random.default_rng(2).integers(-2, 3, (50, 12)).astype(np.float32)

    def loss(xx, yy):
        return jnp.sum(jsparse.sddmm("mul", xx, yy, jnp.asarray(src),
                                     jnp.asarray(dst), jnp.asarray(mask))
                       * jnp.asarray(ct))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    got = _port_grads("mul", x, y, src, dst, mask, None, ct)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))

"""C2 and the LM pool's optimizer: the port's ``sgd``, ``adam``,
``adafactor`` and ``global_norm_clip`` give the dtypes the reference gives
for every mix of bfloat16 and float32 params and gradients (JAX promotes
bfloat16 with a 0-d float32 array to float32, where torch would keep
bfloat16), with values within bfloat16 or float32 tolerance;
``adafactor`` along the reference's 20-step trajectory; the piecewise
updates (``optimizers.CHUNK``) equal to the whole ones; and
``convert.params_from_jax`` carrying bfloat16 leaves bit for bit.

Tolerances: float32 results of float32 operands rtol 1e-5 (atol 1e-7);
any result with a bfloat16 operand rtol 1e-2 (atol 1e-3), a few bfloat16
ulps: JAX casts a weak Python scalar to the array's dtype first (0.9 ->
0.8984375 in bfloat16) where torch multiplies in float32 and rounds once,
so bfloat16 intermediates can sit an ulp apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.optim import optimizers as topt
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = ["float32", "bfloat16"]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = {"m": (6, 5), "s": (2, 4, 3), "v": (7,), "b": ()}


def arrays(seed, dtype):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}, dtype


def to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def to_torch(tree, dtype):
    return {k: torch.from_numpy(np.array(v)).to(TORCH[dtype])
            for k, v in tree.items()}


def leaves_j(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def same(got_tree, want_tree, what, bf=False):
    """Equal dtypes leaf by leaf, values within float32 tolerance, or
    bfloat16's where a leaf or (``bf``) an operand is bfloat16."""
    want = leaves_j(want_tree)
    got = dict(topt.tree_paths(got_tree))
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (what, k)
        bf16 = bf or w.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            g.to(torch.float32).numpy(), np.asarray(w.astype(jnp.float32)),
            rtol=1e-2 if bf16 else 1e-5, atol=1e-3 if bf16 else 1e-7,
            err_msg=f"{what} {k}")


OPTS = {
    "sgd": (lambda: jopt.sgd(0.1), lambda: topt.sgd(0.1), None),
    "sgd_tensor_lr": (lambda: jopt.sgd(0.1), lambda: topt.sgd(0.1), 0.05),
    "sgd_momentum": (lambda: jopt.sgd(0.1, 0.9),
                     lambda: topt.sgd(0.1, 0.9), None),
    "sgd_momentum_tensor_lr": (lambda: jopt.sgd(0.1, 0.9),
                               lambda: topt.sgd(0.1, 0.9), 0.05),
    "adam": (lambda: jopt.adam(1e-3), lambda: topt.adam(1e-3), None),
    "adam_tensor_lr": (lambda: jopt.adam(1e-3), lambda: topt.adam(1e-3),
                       2e-3),
    "adafactor": (lambda: jopt.adafactor(1e-2), lambda: topt.adafactor(1e-2),
                  None),
}


@pytest.mark.parametrize("gdt", DTYPES)
@pytest.mark.parametrize("pdt", DTYPES)
@pytest.mark.parametrize("opt", list(OPTS))
def test_c2_dtype_table(opt, pdt, gdt):
    """Two updates from the same params and gradients: every param and
    state leaf in the reference's dtype (bf16 params and grads through
    adam come out float32 params beside bf16 moments), values close."""
    make_j, make_t, lr = OPTS[opt]
    jo, to = make_j(), make_t()
    p, _ = arrays(0, pdt)
    g, _ = arrays(1, gdt)
    jp, tp = to_jax(p, pdt), to_torch(p, pdt)
    jg, tg = to_jax(g, gdt), to_torch(g, gdt)
    js, ts = jo.init(jp), to.init(tp)
    kw_j = kw_t = {}
    if lr is not None:
        kw_j = {"lr": jnp.asarray(lr, jnp.float32)}
        kw_t = {"lr": torch.tensor(lr, dtype=torch.float32)}
    for step in range(2):
        jp, js = jo.update(jg, js, jp, **kw_j)
        tp, ts = to.update(tg, ts, tp, **kw_t)
        bf = "bfloat16" in (pdt, gdt)
        same(tp, jp, f"{opt} step {step} params", bf)
        same(ts, js, f"{opt} step {step} state", bf)


@pytest.mark.parametrize("gdt", DTYPES)
def test_c2_global_norm_clip_dtypes(gdt):
    g, _ = arrays(2, gdt)
    jc, jn = jopt.global_norm_clip(to_jax(g, gdt), 0.5)
    tc, tn = topt.global_norm_clip(to_torch(g, gdt), 0.5)
    assert tn.dtype == torch.float32 and jn.dtype == jnp.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    same(tc, jc, "clip", gdt == "bfloat16")


def test_adafactor_trajectory_matches_reference():
    """20 updates at the reference's default lr 1e-2 with gradients drawn
    per step (not from the params, so the trajectory is not chaotic)."""
    p, _ = arrays(3, "float32")
    jo, to = jopt.adafactor(1e-2), topt.adafactor(1e-2)
    jp, tp = to_jax(p, "float32"), to_torch(p, "float32")
    js, ts = jo.init(jp), to.init(tp)
    for i in range(20):
        g, _ = arrays(100 + i, "float32")
        g = {k: v * (0.1 + i) for k, v in g.items()}
        jp, js = jo.update(to_jax(g, "float32"), js, jp)
        tp, ts = to.update(to_torch(g, "float32"), ts, tp)
    same(tp, jp, "params")
    same(ts, js, "state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_piecewise_updates_equal_whole(monkeypatch, dtype):
    """Adam's pieces of CHUNK elements are bit for bit the whole update;
    adafactor's row pieces sum in another order (float32 tolerance)."""
    p, _ = arrays(4, dtype)
    g, _ = arrays(5, dtype)
    runs = []
    for chunk in (topt.CHUNK, 7):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        out = []
        for to in (topt.adam(1e-3), topt.adafactor(1e-2)):
            tp = to_torch(p, dtype)
            ts = to.init(tp)
            for _ in range(2):
                tp, ts = to.update(to_torch(g, dtype), ts, tp)
            out.append((tp, ts))
        runs.append(out)
    (adam_a, fac_a), (adam_b, fac_b) = runs
    for (k, a), (_, b) in zip(topt.tree_paths(adam_a),
                              topt.tree_paths(adam_b)):
        assert torch.equal(a, b), k
    for (k, a), (_, b) in zip(topt.tree_paths(fac_a),
                              topt.tree_paths(fac_b)):
        assert a.dtype == b.dtype, k
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_params_from_jax_carries_bfloat16_bits():
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((5, 3)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    tree = {"w": np.asarray(x), "rows": [np.asarray(x[0])],
            "f": rng.standard_normal(4).astype(np.float32)}
    got = convert.params_from_jax(tree, "cpu")
    assert got["w"].dtype == torch.bfloat16
    assert got["rows"][0].dtype == torch.bfloat16
    assert got["f"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    # back through numpy (float32, exact) and into JAX as bfloat16
    back = convert.params_to_numpy(got)
    assert back["w"].dtype == np.float32
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(back["w"]).astype(jnp.bfloat16))
        .view(np.int16), np.asarray(x).view(np.int16))
    np.testing.assert_array_equal(back["f"], tree["f"])
    with pytest.raises(TypeError, match="not a float array"):
        convert.params_from_jax({"ids": np.arange(3, dtype=np.int32)}, "cpu")

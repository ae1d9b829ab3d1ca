"""The port's gradient compression (``repro_torch.optim.compression``,
``repro_torch.pipeline.compress.GradCompressor``) on one device against
the reference's: wire pricing and ``describe()`` equal, the primitives'
contracts (bounded and unbiased stochastic int8, exact top-k
reconstruction with ``lax.top_k``'s tie order, the error-feedback carry),
the int8 row quantizer bit for bit on adversarial rows, and training:
top-k with error feedback along the reference's top-k trajectory, every
scheme within the reference's own tolerances of the exact trajectory
(``tests/test_compression.py``), no compressor by default, and a
compressed run resumed bit for bit — while a reference checkpoint's JAX
key is refused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build as jbuild
from repro.api import get_preset as jget_preset
from repro.optim import compression as J
from repro.pipeline.compress import GradCompressor as JGradCompressor
from repro_torch.api import build, get_preset
from repro_torch.convert import params_from_jax
from repro_torch.optim import compression as C
from repro_torch.optim.optimizers import tree_paths
from repro_torch.pipeline.compress import GradCompressor
from torch_threads import one_torch_thread  # noqa: F401

# the reference's own smoke run (tests/test_compression.py::_OV)
_OV = {"loop.steps": 20, "plan.target_batch": 64, "plan.microbatch": 16,
       "plan.warmup_epochs": 0, "data.edges": 1200, "loop.ckpt_dir": None}


def _smoke(get=get_preset, **overrides):
    return get("lightgcn-smoke").override({**_OV, **overrides})


def _losses(spec, n=20):
    run = build(spec, device="cpu")
    return [run.step() for _ in range(n)]


# ------------------------------------------------------------- pricing
@pytest.mark.parametrize("scheme,frac", [("none", 0.01), ("fp32", 0.01),
                                         ("int8", 0.01), ("topk", 0.01),
                                         ("topk", 0.1), ("topk", 1.0)])
def test_wire_bytes_equal_reference(scheme, frac):
    for n in (1, 7, 1000, 44_695_552):
        assert C.wire_bytes(n, scheme, frac) == J.wire_bytes(n, scheme, frac)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        C.wire_bytes(10, "zstd")


@pytest.mark.parametrize("scheme,frac,ef", [("int8", 0.01, True),
                                            ("int8", 0.01, False),
                                            ("topk", 0.1, True),
                                            ("topk", 0.01, False)])
def test_compressor_pricing_and_describe_equal_reference(scheme, frac, ef):
    jrun = jbuild(_smoke(jget_preset))
    params = jax.tree.map(np.asarray, jrun.state["params"])
    ours = GradCompressor(scheme, frac, ef)
    theirs = JGradCompressor(scheme, frac, ef)
    assert ours.describe() == theirs.describe()
    assert ours.wire_bytes_per_step(params_from_jax(params, "cpu")) == \
        theirs.wire_bytes_per_step(params)
    assert ours.wire_bytes_per_step({"w": np.zeros((100, 4), np.float32)}) \
        == theirs.wire_bytes_per_step({"w": np.zeros((100, 4), np.float32)})


def test_grad_compressor_validation():
    with pytest.raises(ValueError, match="unknown compression scheme"):
        GradCompressor("gzip")
    with pytest.raises(ValueError, match="frac"):
        GradCompressor("topk", frac=1.5)


# ------------------------------------------------------------ primitives
def test_quantize_int8_error_bounded_by_scale():
    for seed in range(5):
        rng = np.random.default_rng(seed)
        g = (rng.standard_normal(512) * 10.0 ** rng.integers(-3, 3)) \
            .astype(np.float32)
        gen = torch.Generator().manual_seed(seed)
        q, scale = C.quantize_int8(torch.from_numpy(g), gen)
        assert q.dtype == torch.int8
        err = np.abs(C.dequantize_int8(q, scale).numpy() - g)
        assert err.max() <= float(scale) * (1 + 1e-5), seed


def test_quantize_int8_unbiased():
    """The reference's bound: over 400 independent draws the mean
    dequantized value is within 0.15 x scale of the input."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                         .astype(np.float32))
    outs = [C.dequantize_int8(*C.quantize_int8(
        g, torch.Generator().manual_seed(k))).numpy() for k in range(400)]
    _, scale = C.quantize_int8(g, torch.Generator().manual_seed(0))
    bias = np.abs(np.mean(outs, 0) - g.numpy()).max()
    assert bias < float(scale) * 0.15, bias


def _tied(seed):
    """A gradient with ties among equal non-zero magnitudes across the
    k-th place, of both signs, and runs of zeros."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-4, 5, (24, 7)).astype(np.float32) * 0.25
    g[rng.random((24, 7)) < 0.2] = 0.0
    return g


@pytest.mark.parametrize("k", [1, 13, 40, 100, 168])
def test_topk_keeps_the_references_set_under_ties(k):
    """``lax.top_k`` keeps the lowest indices among ties; so does the
    port: the kept indices, values, residual and densified tensor equal
    the reference's exactly."""
    for seed in range(4):
        g = _tied(seed)
        kept, idx, residual = C.topk_sparsify(torch.from_numpy(g), k)
        jkept, jidx, jresidual = J.topk_sparsify(jnp.asarray(g), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
        np.testing.assert_array_equal(residual.numpy(),
                                      np.asarray(jresidual))
        dense = C.topk_densify(kept, idx, g.shape)
        np.testing.assert_array_equal(
            dense.numpy(), np.asarray(J.topk_densify(jkept, jidx, g.shape)))
        np.testing.assert_array_equal(dense.numpy() + residual.numpy(), g)


def test_topk_densify_accumulates_collisions():
    vals = torch.tensor([1.0, 2.0, 3.0])
    idx = torch.tensor([4, 1, 4])
    np.testing.assert_array_equal(
        C.topk_densify(vals, idx, (2, 3)).numpy(),
        np.asarray(J.topk_densify(jnp.asarray(vals.numpy()),
                                  jnp.asarray(idx.numpy()), (2, 3))))


def test_error_feedback_residual_carry_invariant():
    """compressed + residual == grads + carried error, exactly, every
    leaf, for both compressors."""
    rng = np.random.default_rng(0)
    grads = {"a": torch.from_numpy(rng.standard_normal((11, 5))
                                   .astype(np.float32)),
             "b": [torch.from_numpy(rng.standard_normal(17)
                                    .astype(np.float32))]}
    errors = {"a": torch.from_numpy(rng.standard_normal((11, 5))
                                    .astype(np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(17)
                                     .astype(np.float32))]}
    assert [p for p, _ in tree_paths(C.ErrorFeedback.init(grads))] == \
        ["['a']", "['b'][0]"]
    for fn in (C.make_topk_compressor(0.25),
               C.make_int8_compressor(torch.Generator().manual_seed(0))):
        g_hat, new_e = C.ErrorFeedback.apply(grads, errors, fn)
        for (p, g), (_, e), (_, h), (_, n) in zip(
                tree_paths(grads), tree_paths(errors), tree_paths(g_hat),
                tree_paths(new_e)):
            torch.testing.assert_close(h + n, g + e, rtol=0, atol=1e-6,
                                       msg=p)


def _adversarial_rows():
    """Rows where a last-bit difference would show: all zeros, maxima
    that are multiples of 127 (and of 127 x 2^k), values exactly halfway
    between two quanta, ties to even either way, subnormal-scale rows,
    and one-hot rows."""
    rows = [np.zeros(8, np.float32),
            np.array([127, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5, -2.5],
                     np.float32),
            np.array([254, 1, 3, 5, -7, 127, -127, 0], np.float32),
            np.array([127 * 3, 1.5 * 3, 2.5 * 3, -0.5 * 3, 3.5 * 3,
                      -126.5 * 3, 0, 1e-30], np.float32),
            np.array([127 * 2.0 ** -20] + [k * 2.0 ** -21
                                           for k in range(1, 8)],
                     np.float32),
            np.array([1e-38, -1e-38, 5e-39, 0, 0, 0, 0, 0], np.float32),
            np.eye(8, dtype=np.float32)[3] * -7.25]
    rng = np.random.default_rng(0)
    for _ in range(64):
        m = np.float32(rng.uniform(0.1, 100.0))
        # halfway points of this row's own quanta
        scale = np.float32(m / np.float32(127.0) + np.float32(1e-12))
        half = (rng.integers(-126, 126, 7) + 0.5).astype(np.float32) * scale
        rows.append(np.concatenate([[m], half]).astype(np.float32))
    return np.stack(rows)


def test_row_quantizer_on_tensors_equals_numpy_bitwise():
    table = _adversarial_rows()
    q, scale = C.quantize_rows_int8(table)
    jq, jscale = J.quantize_rows_int8(table)
    tq, tscale = C.quantize_rows_int8_tensor(torch.from_numpy(table))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(tq.numpy(), q)
    assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tscale.numpy().view(np.int32),
                                  scale.view(np.int32))
    np.testing.assert_array_equal(
        (tq.float() * tscale).numpy(), J.dequantize_rows_int8(jq, jscale))


# ------------------------------------------------------------ training
def test_default_compression_builds_nothing():
    base = build(_smoke(), device="cpu")
    assert base.pipeline.compressor is None
    assert set(base.state) == {"params", "opt"}
    explicit = build(_smoke(**{"compression.grads": "none"}), device="cpu")
    assert [base.step() for _ in range(5)] == \
        [explicit.step() for _ in range(5)]


def test_topk_follows_the_references_topk_trajectory():
    """top-k with error feedback, frac 0.1, is deterministic: from the
    reference's init its 20 losses stay within rtol 1e-4 of the
    reference's top-k run, and two runs are bitwise equal."""
    ov = {"compression.grads": "topk", "compression.frac": 0.1}
    jrun = jbuild(_smoke(jget_preset, **ov))
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jrun.state["params"]), "cpu")
    runs = []
    for _ in range(2):
        run = build(_smoke(**ov), device="cpu")
        run.state = run.pipeline.apply_plan({
            "params": params, "opt": run.pipeline.opt.init(params),
            "comp": run.pipeline.compressor.init_state(params, 0)})
        runs.append([run.step() for _ in range(20)])
    assert runs[0] == runs[1]
    want = [jrun.step() for _ in range(20)]
    np.testing.assert_allclose(runs[0], want, rtol=1e-4)


def test_compressed_runs_track_the_exact_trajectory():
    """The reference's single-device tolerances against the exact run:
    int8 rtol 1e-3 / atol 1e-4; top-k + EF rtol 5e-3 / atol 2e-3; top-k
    without EF rtol 2e-2 / atol 5e-3.  The compressor state rides the
    training state."""
    exact = _losses(_smoke())
    int8 = build(_smoke(**{"compression.grads": "int8"}), device="cpu")
    assert set(int8.state) == {"params", "opt", "comp"}
    assert set(int8.state["comp"]) == {"key", "ef"}
    l_int8 = [int8.step() for _ in range(20)]
    np.testing.assert_allclose(l_int8, exact, rtol=1e-3, atol=1e-4)
    l_topk = _losses(_smoke(**{"compression.grads": "topk",
                               "compression.frac": 0.1}))
    np.testing.assert_allclose(l_topk, exact, rtol=5e-3, atol=2e-3)
    l_noef = _losses(_smoke(**{"compression.grads": "topk",
                               "compression.frac": 0.1,
                               "compression.error_feedback": False}))
    np.testing.assert_allclose(l_noef, exact, rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("grads", ["int8", "topk"])
def test_compressed_run_resumes_bitwise(tmp_path, grads):
    """Checkpointed after 2 steps and resumed for 2, a compressed run
    equals the uninterrupted one bit for bit, its key included."""
    ov = {"compression.grads": grads, "compression.frac": 0.1,
          "loop.steps": 4, "loop.ckpt_every": 2}
    whole = build(_smoke(**ov), device="cpu")
    rep = whole.fit()
    first = build(_smoke(**ov, **{"loop.ckpt_dir": str(tmp_path)}),
                  device="cpu")
    first.fit(steps=2)
    resumed = build(_smoke(**ov), device="cpu").resume(str(tmp_path))
    assert resumed.fit(steps=2).losses == rep.losses[2:]
    assert resumed.state["comp"]["key"].tolist() == \
        whole.state["comp"]["key"].tolist() == [(0 ^ 0x5EEDC0DE), 4]
    for (p, a), (_, b) in zip(tree_paths(resumed.state),
                              tree_paths(whole.state)):
        assert torch.equal(a, b), p


def test_reference_compressed_checkpoint_is_refused(tmp_path):
    """The reference's key is a ``jax.random`` uint32 key, which the
    port's generators cannot continue: restoring it raises instead of
    silently re-seeding."""
    ov = {"compression.grads": "int8", "loop.steps": 2,
          "loop.ckpt_dir": str(tmp_path)}
    jbuild(_smoke(jget_preset, **ov)).fit()
    run = build(_smoke(**{"compression.grads": "int8"}), device="cpu")
    with pytest.raises(ValueError, match=r"\['comp'\]\['key'\]"):
        run.resume(str(tmp_path))

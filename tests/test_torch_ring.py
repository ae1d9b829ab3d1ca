"""The port's ring SpMM (``dist.ring_spmm`` through ``pipeline.sparse``'s
ring dispatch) against the dense operator, at P = 1, 2 and 4 gloo ranks
spawned on the CPU (``torch_ranks``), and in one process at one shard.

The reference's ring cannot serve as the oracle here: its ``shard_map``
rejects the ring's loop carry on this JAX (the varying manual axes of
``src/repro/dist/ring_spmm.py:206``), even on one device.  So the ring is
held to the dense numpy operator it computes, float64 sums against the
port's float32, rtol = atol = 1e-5:

  * the symmetric propagation and the directional rings, full, banded
    (only edges within ``ring_steps`` owners) and with the int8 payload
    (remote blocks through the reference's per-block int8 round trip,
    the local block exact);
  * gradients equal to the transpose operator (the banded one's: the
    reversed kept edges over the full ring);
  * ``steps − 1`` rotations a call, the int8 payload a quarter of fp32's
    plus one scale per rotation.

The compression collectives the sharded gradient combine runs over the
same group (``optim.compression``) are held to numpy here too.
"""
import numpy as np
import pytest
import torch

from repro_torch.pipeline.sparse import BipartiteCSR
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
NU, NI, E, D = 13, 9, 60, 4


def _graph():
    rng = np.random.default_rng(0)
    user = rng.integers(0, NU, E).astype(np.int32)
    item = rng.integers(0, NI, E).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(user=user, item=item, n_users=NU, n_items=NI,
                x_user=f(NU, D), x_item=f(NI, D), c_user=f(NU, D),
                c_item=f(NI, D))


def _cases(world):
    band = [(world // 2, False), (world // 2, True)] if world > 1 else []
    return [(None, False), (None, True)] + band


@pytest.fixture(scope="module", params=[1, 2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    graph = _graph()
    res = run_ranks(tmp_path_factory.mktemp("ring"), world, "ring_ops",
                    cases=_cases(world), **graph)
    return world, graph, res


def _rsqrt(idx, n):
    deg = np.bincount(idx, minlength=n).astype(np.float32)
    return 1.0 / np.sqrt(np.maximum(deg, np.float32(1.0)))


def _deq_blocks(v, n_local):
    """The int8 round trip of each rank's block, as the ring rotates it."""
    out = np.empty_like(v)
    for lo in range(0, len(v), n_local):
        b = v[lo:lo + n_local]
        scale = np.float32(np.abs(b).max()) / np.float32(127.0) \
            + np.float32(1e-12)
        q = np.clip(np.rint(b / scale), -127, 127).astype(np.float32)
        out[lo:lo + n_local] = q * scale
    return out


def _ring(src, dst, v, n_local, p, steps, quant):
    """What the ring computes on unified rows ``v`` [n_pad, D]: every edge
    within the band adds its source row — the int8 round trip of it when
    the source lives on another rank and the payload is int8."""
    rel = (src // n_local - dst // n_local) % p
    keep = rel < steps
    s, d, rel = src[keep], dst[keep], rel[keep]
    rows = v.astype(np.float64)
    if quant:
        remote = _deq_blocks(v, n_local).astype(np.float64)
        vals = np.where((rel == 0)[:, None], rows[s], remote[s])
    else:
        vals = rows[s]
    out = np.zeros(v.shape, np.float64)
    np.add.at(out, d, vals)
    return out


def _expect(world, graph, case, n_local):
    """(sym forward, linear-loss grads, u2i, i2u, band-kept sym edges)."""
    steps, quant = case
    steps = world if steps is None else steps
    nu, ni = graph["n_users"], graph["n_items"]
    n_pad = n_local * world
    u = graph["user"].astype(np.int64)
    i = graph["item"].astype(np.int64) + nu
    sym_s, sym_d = np.concatenate([u, i]), np.concatenate([i, u])
    rdu, rdi = _rsqrt(graph["user"], nu), _rsqrt(graph["item"], ni)

    def lift(x, off):
        z = np.zeros((n_pad, x.shape[1]), np.float32)
        z[off:off + len(x)] = x
        return z

    z = lift(np.concatenate([graph["x_user"] * rdu[:, None],
                             graph["x_item"] * rdi[:, None]]), 0)
    h = _ring(sym_s, sym_d, z, n_local, world, steps, quant)
    fwd = (h[:nu] * rdu[:, None], h[nu:nu + ni] * rdi[:, None])
    # the transpose: the same edges unbanded, else the kept ones reversed
    # over the full ring
    rel = (sym_s // n_local - sym_d // n_local) % world
    ks, kd = sym_s[rel < steps], sym_d[rel < steps]
    t_src, t_dst, t_steps = (sym_s, sym_d, steps) if steps == world \
        else (kd, ks, world)
    ct = lift(np.concatenate([graph["c_user"] * rdu[:, None],
                              graph["c_item"] * rdi[:, None]]), 0)
    gz = _ring(t_src, t_dst, ct, n_local, world, t_steps, quant)
    lin = (gz[:nu] * rdu[:, None], gz[nu:nu + ni] * rdi[:, None])
    u2i = _ring(u, i, lift(graph["x_user"], 0), n_local, world, steps,
                quant)[nu:nu + ni]
    i2u = _ring(i, u, lift(graph["x_item"], nu), n_local, world, steps,
                quant)[:nu]
    return fwd, lin, u2i, i2u, (ks, kd)


def test_ring_forward_matches_dense(ranks):
    world, graph, res = ranks
    for c, case in enumerate(_cases(world)):
        got = res[0][c]
        fwd, _, u2i, i2u, _ = _expect(world, graph, case, got["n_local"])
        for a, b in zip(got["h"], fwd):
            np.testing.assert_allclose(a, b, **TOL, err_msg=str(case))
        np.testing.assert_allclose(got["u2i"], u2i, **TOL)
        np.testing.assert_allclose(got["i2u"], i2u, **TOL)
        assert got["fused_hadamard"] is False
        for other in res[1:]:                  # every rank, the same rows
            for a, b in zip(other[c]["h"], got["h"]):
                np.testing.assert_array_equal(a, b)


def test_ring_gradients_are_the_transpose(ranks):
    """Linear loss (all cases, int8 included: the cotangent's remote
    blocks round-trip through int8) and a nonlinear loss against float64
    autograd through the dense (band-kept) operator (fp32 payloads)."""
    world, graph, res = ranks
    nu, ni = graph["n_users"], graph["n_items"]
    rdu = torch.from_numpy(_rsqrt(graph["user"], nu)).double()[:, None]
    rdi = torch.from_numpy(_rsqrt(graph["item"], ni)).double()[:, None]
    for c, case in enumerate(_cases(world)):
        got = res[0][c]
        _, lin, _, _, (ks, kd) = _expect(world, graph, case, got["n_local"])
        for a, b in zip(got["lin_grads"], lin):
            np.testing.assert_allclose(a, b, **TOL, err_msg=str(case))
        if case[1]:
            continue
        a = torch.zeros((nu + ni, nu + ni), dtype=torch.float64)
        a.index_put_((torch.from_numpy(kd), torch.from_numpy(ks)),
                     torch.ones(len(ks), dtype=torch.float64),
                     accumulate=True)
        xu = torch.from_numpy(graph["x_user"]).double().requires_grad_(True)
        xi = torch.from_numpy(graph["x_item"]).double().requires_grad_(True)
        h = a @ torch.cat([xu * rdu, xi * rdi])
        loss = ((h[:nu] * rdu) ** 2).sum() + ((h[nu:] * rdi) ** 3).sum()
        want = torch.autograd.grad(loss, (xu, xi))
        for g, w in zip(got["grads"], want):
            np.testing.assert_allclose(g, w.numpy(), **TOL,
                                       err_msg=str(case))


def test_ring_rotates_steps_minus_one_and_counts_payload(ranks):
    world, graph, res = ranks
    for c, (steps, quant) in enumerate(_cases(world)):
        steps = world if steps is None else steps
        for r in res:
            rotations, payload = r[c]["counts"]
            n_local = r[c]["n_local"]
            assert rotations == steps - 1
            fp32 = rotations * n_local * D * 4
            # int8: a quarter of the fp32 block plus one fp32 scale
            want = fp32 // 4 + 4 * rotations if quant else fp32
            assert payload == want, (steps, quant)


def test_one_shard_ring_in_process_matches_csr_route():
    """impl='ring' without a process group: one bucket, no rotation, the
    CSR route's results and gradients."""
    graph = _graph()
    kw = {k: graph[k] for k in ("user", "item", "n_users", "n_items")}
    csr = BipartiteCSR(device="cpu", **kw)
    ring = BipartiteCSR(device="cpu", impl="ring", **kw)
    assert ring.spmm == "ring" and ring.shard.n_shards == 1
    assert ring.fused_hadamard is False and csr.fused_hadamard is True
    outs = []
    for g in (csr, ring):
        xu = torch.from_numpy(graph["x_user"]).requires_grad_(True)
        xi = torch.from_numpy(graph["x_item"]).requires_grad_(True)
        hu, hi = g.sym_propagate(xu, xi)
        loss = (hu ** 2).sum() + (hi ** 3).sum()
        outs.append([hu, hi, *torch.autograd.grad(loss, (xu, xi)),
                     g.agg_u2i(xu), g.agg_i2u(xi)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **TOL)
    assert ring._ring.ring("sym").rotations == 0
    assert ring.port_ring_nbytes() > 0


def test_compression_collectives_match_numpy(tmp_path):
    """Over 4 ranks: the int8 all-reduce is the sum within one shared
    scale per rank (the max-reduced max|g| / 127), equals the residual
    variant's from the same generators, whose residuals account for the
    rest to fp32 rounding; the top-k all-gather sum is the sum of every
    rank's densified top k (colliding indices accumulate)."""
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((4, 6, 5)).astype(np.float32)
    grads[2] *= 3.0                            # one rank sets the scale
    k = 7
    ranks = run_ranks(tmp_path, 4, "collectives", grads=grads, seed=11, k=k)
    scale = max(np.abs(g).max() / np.float32(127.0) + np.float32(1e-12)
                for g in grads)
    exact = grads.astype(np.float64).sum(0)
    want_topk = np.zeros(grads[0].size, np.float64)
    for g in grads:
        flat = g.reshape(-1)
        top = np.argsort(-np.abs(flat), kind="stable")[:k]
        np.add.at(want_topk, top, flat[top])
    for r in ranks:
        np.testing.assert_array_equal(r["total"], ranks[0]["total"])
        np.testing.assert_array_equal(r["again"], r["total"])
        np.testing.assert_array_equal(r["topk"], ranks[0]["topk"])
        assert np.abs(r["resid"]).max() < scale
        np.testing.assert_allclose(r["topk"], want_topk.reshape(6, 5),
                                   rtol=1e-6, atol=0)
    assert np.abs(ranks[0]["total"] - exact).max() <= 4 * scale
    kept = exact - sum(r["resid"].astype(np.float64) for r in ranks)
    np.testing.assert_allclose(ranks[0]["total"], kept, rtol=1e-5,
                               atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_ring_kernel_route_matches_plain_on_card(dev):
    """At one shard on the card each ring step is one ``spmm_csr`` launch;
    held against the plain route on the same graph, one bucket row longer
    than a merge-path chunk (``kernels.spmm.CHUNK``)."""
    from repro_torch import kernels
    from repro_torch.kernels.spmm import CHUNK
    rng = np.random.default_rng(0)
    nu, ni, e = 3000, 200, 20_000
    user = rng.integers(0, nu, e).astype(np.int32)
    item = rng.integers(0, ni, e).astype(np.int32)
    item[:3 * CHUNK] = 7                      # one item row of > 3 chunks
    xu = torch.randn(nu, 64, device=dev)
    xi = torch.randn(ni, 64, device=dev)
    outs = []
    for impl in ("cuda", "torch"):
        g = BipartiteCSR(user, item, nu, ni, device=dev, impl="ring")
        g._ring.impl = impl
        kernels.reset_launch_counts()
        outs.append(g.sym_propagate(xu, xi))
        launches = kernels.launch_counts()["spmm_csr"]
        assert launches == (1 if impl == "cuda" else 0)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

"""The merge-path row split behind the ``hadamard_spmm`` kernel, on the CPU.

The CUDA kernel cuts rows + edges into chunks of ``CHUNK`` merge items
(``kernels/row_split.py``, ``csrc/row_split.cuh``) as ``spmm_csr``'s
does; ``emulate`` replays its two passes in numpy with the shared replay
of ``tests/row_split_replay.py``: each term is x[x_idx] * y[y_idx]
rounded to fp32 and added in edge order; a row that ends inside its
chunk is written with the (scale, leaky-relu) epilogue; a split row
leaves pre-epilogue head and open partials, summed in chunk order, and
the epilogue is applied once, after the sum.  Cases: the spmm split
graphs at T in {16, 64, CHUNK}, with and without the epilogue (negative
scales included), general indices and ``y_is_dst``-shaped ones (y rides
the destination, as in NGCF's forward and its d_y call).  The replay is
held to the port's plain version and the reference's XLA oracle: bitwise
on integer-valued rows (every sum exact), else within 1e-5 + 1e-5 x the
sum of |terms| (each chunk adds up to T terms in series); and, on a
small case, to the reference's Pallas kernel in interpret mode.
``emulate_shared`` replays the kernel's shared-index route (x_idx is
y_idx, as in NGCF's d_x): x * y formed once per row both tables hold,
one row of it per edge through the same two passes; it is held bit for
bit to ``emulate`` with the index passed twice, on tables of different
row counts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from row_split_replay import cases, graph, replay

from repro.kernels import ref as jref
from repro.kernels.hadamard_spmm import hadamard_spmm_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.hadamard_spmm import CHUNK

RTOL = ATOL = 1e-5
SLOPE = 0.2


def _finisher(scale, slope):
    """The (scale, leaky-relu) epilogue of one complete row."""
    def finish(r, acc):
        v = acc * scale[r] if scale is not None else acc
        if slope is not None:
            v = np.where(v >= 0, v, v * np.float32(slope))
        return v.astype(np.float32)
    return finish


def emulate(x, y, indptr, x_idx, y_idx, n, t, scale=None, slope=None):
    """The kernel's two passes: fp32 products summed per chunk in edge
    order, split rows combined in chunk order, the epilogue once per row."""
    terms = x[x_idx] * y[y_idx]
    return replay(terms, indptr, n, len(x_idx), t, np.add, np.float32(0.0),
                  _finisher(scale, slope))


def emulate_shared(x, y, indptr, idx, n, t, scale=None, slope=None):
    """The shared-index route: the product kernel's p = x * y over the
    rows both tables hold, then the same two passes over one row of p per
    edge."""
    rows = min(len(x), len(y))
    prod = x[:rows] * y[:rows]
    return replay(prod[idx], indptr, n, len(idx), t, np.add,
                  np.float32(0.0), _finisher(scale, slope))


def _inputs(case, t, structure, integer, seed):
    """(x, y, indptr, x_idx, y_idx, n, scale) on the split graph of ``case``;
    ``y_is_dst`` makes y_idx the edge's destination row."""
    indptr, n, x_idx = graph(case, t, seed)
    rng = np.random.default_rng(seed + 1)
    n_y = len(indptr) - 1
    if structure == "y_is_dst":
        y_idx = np.repeat(np.arange(n_y), np.diff(indptr)).astype(np.int32)
    else:
        y_idx = rng.integers(0, n_y, len(x_idx)).astype(np.int32)

    def feats(*shape):
        if integer:
            return rng.integers(-3, 4, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    scale = (rng.integers(-2, 3, n) if integer
             else rng.standard_normal(n)).astype(np.float32)
    return feats(97, 8), feats(n_y, 8), indptr, x_idx, y_idx, n, scale


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("structure", ["general", "y_is_dst"])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("case,t", cases(CHUNK))
def test_two_pass_emulation_matches_references(case, t, epilogue, structure,
                                               integer):
    x, y, indptr, x_idx, y_idx, n, scale = _inputs(case, t, structure,
                                                   integer, seed=t + 5)
    kw = dict(scale=scale, slope=SLOPE) if epilogue else {}
    got = emulate(x, y, indptr, x_idx, y_idx, n, t, **kw)
    tk = dict(scale=torch.from_numpy(scale), slope=SLOPE) if epilogue else {}
    args = (torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(indptr), torch.from_numpy(x_idx),
            torch.from_numpy(y_idx), n)
    want = ref.hadamard_spmm_ref(*args, **tk).numpy()
    jk = dict(scale=jnp.asarray(scale), slope=SLOPE) if epilogue else {}
    jwant = np.asarray(jref.hadamard_spmm_ref(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(indptr),
        jnp.asarray(x_idx), jnp.asarray(y_idx), n, **jk))
    if integer:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jwant)
    else:
        abs_kw = dict(scale=torch.from_numpy(np.abs(scale))) if epilogue \
            else {}
        abs_sum = ref.hadamard_spmm_ref(
            torch.from_numpy(np.abs(x)), torch.from_numpy(np.abs(y)),
            *args[2:], **abs_kw).numpy()
        for w in (want, jwant):
            assert (np.abs(got - w) <= ATOL + RTOL * abs_sum).all()
    empty = np.diff(indptr[: n + 1]) == 0
    np.testing.assert_array_equal(got[empty], 0.0)
    if epilogue and case != "no_edges":
        assert (got < 0).any()             # the negative branch was taken


@pytest.mark.parametrize("structure", ["general", "y_is_dst"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_two_pass_emulation_matches_pallas_interpret(epilogue, structure):
    """Integer-valued rows on the boundary graph at T = 16 (rows of T - 1,
    T, T + 1 and 3T edges, one starting on a chunk boundary): the replay
    equals the reference's Pallas kernel bit for bit."""
    x, y, indptr, x_idx, y_idx, n, scale = _inputs("exact", 16, structure,
                                                   True, seed=3)
    kw = dict(scale=scale, slope=SLOPE) if epilogue else {}
    got = emulate(x, y, indptr, x_idx, y_idx, n, 16, **kw)
    jk = dict(scale=jnp.asarray(scale), slope=SLOPE) if epilogue else {}
    want = np.asarray(hadamard_spmm_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(indptr.astype(np.int32)),
        jnp.asarray(x_idx), jnp.asarray(y_idx), n, row_block=4,
        interpret=True, **jk))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("case,t", cases(CHUNK))
def test_shared_index_emulation_matches_general_bitwise(case, t, epilogue,
                                                        integer):
    """x_idx is y_idx: the shared-index replay equals the general replay
    with the index passed twice, bit for bit, on x of 97 rows and y of 131
    (the product covers the 97 both hold), with and without the epilogue,
    on integer-valued and normal inputs."""
    indptr, n, idx = graph(case, t, seed=t + 7)
    rng = np.random.default_rng(t + 8)

    def feats(*shape):
        if integer:
            return rng.integers(-3, 4, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    x, y, scale = feats(97, 8), feats(131, 8), feats(n)
    kw = dict(scale=scale, slope=SLOPE) if epilogue else {}
    got = emulate_shared(x, y, indptr, idx, n, t, **kw)
    np.testing.assert_array_equal(
        got, emulate(x, y, indptr, idx, idx, n, t, **kw))
    empty = np.diff(indptr[: n + 1]) == 0
    np.testing.assert_array_equal(got[empty], 0.0)
    if case != "no_edges":
        assert np.isfinite(got).all() and (got != 0).any()

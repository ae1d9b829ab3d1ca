"""The merge-path partition behind the ``spmm_csr`` kernel, on the CPU.

``kernels/row_split.py`` builds the chunk table the CUDA kernel reads;
``emulate`` below replays the kernel's two passes in numpy, chunk by
chunk, with the bounds of ``csrc/row_split.cuh`` (the replay in
``tests/row_split_replay.py`` is shared with ``hadamard_spmm``'s): rows
that end inside a chunk are written directly, a row that crosses a chunk boundary leaves
one partial per chunk (the chunk's "open" slot, and a "head" slot in the
chunk that completes it), combined in chunk order.  The graphs are
seeded numpy Zipf graphs with one row spanning many chunks, rows of
T - 1, T and T + 1 edges, a row that starts exactly on a chunk boundary,
empty and trailing rows, E = 0, and an ``indptr`` longer than
``n_nodes + 1``.  The emulation is held to the plain version
(``ref.spmm_csr_ref``) and the reference's XLA oracle: to rtol = atol =
1e-5 on integer-valued rows (exact sums) and for max, and to 1e-5 + 1e-5
x the sum of |terms| on real-valued sums (each chunk adds up to T terms
in series, as the kernel does)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from row_split_replay import cases, graph, replay, walk

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.spmm import CHUNK

RTOL = ATOL = 1e-5


def emulate(reduce, values, indptr, src, n, gather, t):
    """The kernel's two passes in numpy (``row_split_replay.replay``):
    per-chunk partials, then each split row's partials combined in chunk
    order by the chunk that completes it; an empty max row gives 0."""
    vals = values[src] if gather else values
    e_shape = len(src) if gather else len(values)
    if reduce == "max":
        return replay(vals, indptr, n, e_shape, t, np.maximum,
                      np.float32(-np.inf),
                      lambda r, acc: np.where(np.isfinite(acc), acc,
                                              np.float32(0)))
    return replay(vals, indptr, n, e_shape, t, np.add, np.float32(0.0),
                  lambda r, acc: acc)


@pytest.mark.parametrize("case,t", cases(CHUNK))
def test_chunks_cover_every_edge_once(case, t):
    """Every edge of rows < n_nodes is walked by exactly one chunk, and no
    chunk reads an edge at or past ``indptr[n_nodes]``; no chunk walks
    more than T edges."""
    indptr, n, src = graph(case, t, seed=t)
    _, steps = walk(indptr, n, len(src), t)
    seen = np.zeros(max(len(src), 1), np.int64)
    per_chunk = {}
    for c, _, lo, hi, _ in steps:
        assert 0 <= lo <= hi <= indptr[n]
        seen[lo:hi] += 1
        per_chunk[c] = per_chunk.get(c, 0) + hi - lo
    assert (seen[: indptr[n]] == 1).all() and (seen[indptr[n]:] == 0).all()
    assert max(per_chunk.values(), default=0) <= t


@pytest.mark.parametrize("case,t", cases(CHUNK))
def test_every_row_has_one_owner_or_one_combine(case, t):
    """Each row < n_nodes is written exactly once: directly by the chunk
    holding all of it, or by the one combine step of the chunk that
    completes it, whose partials come from consecutive chunks.  (A row
    whose first edge sits on the next chunk boundary is left open with no
    edges: the combine starts past that slot and never reads it.)"""
    indptr, n, src = graph(case, t, seed=t + 1)
    _, steps = walk(indptr, n, len(src), t)
    writes = np.zeros(n, np.int64)
    parts = {}
    for c, r, lo, hi, kind in steps:
        if kind != "open":
            writes[r] += 1
        if kind == "head" or (kind == "open" and hi > lo):
            parts.setdefault(r, []).append(c)
    assert (writes == 1).all()
    for r, chunks in parts.items():
        assert chunks == list(range(chunks[0], chunks[0] + len(chunks)))
        assert chunks[0] == (indptr[r] + r) // t and len(chunks) >= 2
    if case in ("zipf", "exact"):
        assert max(map(len, parts.values())) >= 3      # spans many chunks


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("case,t", cases(CHUNK))
def test_two_pass_emulation_matches_references(case, t, reduce, gather,
                                               integer):
    """Integer-valued rows make every fp32 sum exact, so there the split
    order must give the plain version's bits, and both references agree
    to rtol = atol = 1e-5.  Real-valued sums are held as the chip run
    holds the kernel at its main shape: |err| <= 1e-5 + 1e-5 x the sum of
    |terms| per element, since each chunk adds up to T terms serially
    (max is exact either way)."""
    indptr, n, src = graph(case, t, seed=t + 2)
    rng = np.random.default_rng(t + 3)
    shape = (97 if gather else len(src), 8)
    values = (rng.integers(-3, 4, shape) if integer
              else rng.standard_normal(shape)).astype(np.float32)
    got = emulate(reduce, values, indptr, src, n, gather, t)
    args = (torch.from_numpy(indptr), torch.from_numpy(src), n)
    want = ref.spmm_csr_ref(reduce, torch.from_numpy(values), *args,
                            gather=gather).numpy()
    jwant = np.asarray(jref.spmm_csr_ref(reduce, jnp.asarray(values),
                                         jnp.asarray(indptr),
                                         jnp.asarray(src), n, gather=gather))
    if integer or reduce == "max":
        for w in (want, jwant):
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)
        if integer:
            np.testing.assert_array_equal(got, want)
    else:
        abs_sum = ref.spmm_csr_ref("sum", torch.from_numpy(np.abs(values)),
                                   *args, gather=gather).numpy()
        for w in (want, jwant):
            assert (np.abs(got - w) <= ATOL + RTOL * abs_sum).all()
    empty = np.diff(indptr[: n + 1]) == 0
    np.testing.assert_array_equal(got[empty], 0.0)

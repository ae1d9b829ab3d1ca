"""The merge-path partition behind the ``spmm_csr`` kernel, on the CPU.

``kernels/row_split.py`` builds the chunk table the CUDA kernel reads;
``emulate`` below replays the kernel's two passes in numpy, chunk by
chunk, with the bounds of ``csrc/row_split.cuh``: rows that end inside a
chunk are written directly, a row that crosses a chunk boundary leaves
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

from repro.kernels import ref as jref
from repro_torch.kernels import ref, row_split
from repro_torch.kernels.spmm import CHUNK

RTOL = ATOL = 1e-5
CASES = ("zipf", "exact", "no_edges", "long_indptr")


def _boundary_degrees(t):
    """Rows of T - 1, T and T + 1 edges, empty rows, then a pad row sized
    so that the next row (3T edges) starts exactly on a chunk boundary."""
    degs = [t - 1, t, t + 1, 0, 0, 5]
    pos = sum(degs) + len(degs)        # merge position of the next row
    degs.append((-(pos + 1)) % t)      # the pad row adds pad + 1 items
    return degs + [3 * t, 1, 0, t - 1, 0, 0]


def _graph(case, t, seed):
    """(indptr i64[rows + 1], n_nodes, edges' source ids) for one case;
    rows >= n_nodes exist only in ``long_indptr``."""
    rng = np.random.default_rng(seed)
    if case == "zipf":
        n, e = 300, 40 * t
        dst = np.minimum(rng.zipf(1.4, e) - 1, n - 6)   # 5 trailing empty
        dst[: e // 2 + 1] = 3                           # one row > 50 % of E
        degs = np.bincount(dst, minlength=n)
    elif case == "exact":
        degs = np.array(_boundary_degrees(t))
        n = len(degs)
    elif case == "no_edges":
        n = 2 * t + 3
        degs = np.zeros(n, np.int64)
    else:                                  # the caller passes fewer rows
        degs = np.array(_boundary_degrees(t) + [t + 1, 7, 2 * t])
        n = len(degs) - 3
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    src = rng.integers(0, 97, int(indptr[-1])).astype(np.int32)
    assert case == "no_edges" or (degs[:n] == 0).any()
    return indptr, n, src


def _bounds(indptr, rows, c, t):
    """``row_split::bounds`` of csrc/row_split.cuh."""
    i0, i1 = int(rows[c]), int(rows[c + 1])
    j0, j1 = c * t - i0, (c + 1) * t - i1
    return i0, i1, j0, j1, i0 < i1 and j0 > indptr[i0]


def _walk(indptr, n, e_shape, t):
    """Each chunk's edge ranges: (chunk, row, lo, hi, kind), kind one of
    'direct', 'head', 'open', in the kernel's order."""
    rows = row_split.chunk_rows(torch.from_numpy(indptr), n, e_shape,
                                t).numpy()
    assert len(rows) == row_split.n_chunks(n, e_shape, t) + 1
    assert rows[0] == 0 and rows[-1] == n and (np.diff(rows) >= 0).all()
    steps = []
    for c in range(len(rows) - 1):
        i0, i1, j0, j1, head_split = _bounds(indptr, rows, c, t)
        for r in range(i0, i1):
            lo = j0 if r == i0 else int(indptr[r])
            kind = "head" if r == i0 and head_split else "direct"
            steps.append((c, r, lo, int(indptr[r + 1]), kind))
        if i1 < n:
            steps.append((c, i1, j0 if i1 == i0 else int(indptr[i1]), j1,
                          "open"))
    return rows, steps


def emulate(reduce, values, indptr, src, n, gather, t):
    """The kernel's two passes in numpy: per-chunk partials, then each
    split row's partials combined in chunk order by the chunk that
    completes it."""
    vals = values[src] if gather else values
    e_shape = len(src) if gather else len(values)
    rows, steps = _walk(indptr, n, e_shape, t)
    op = np.maximum if reduce == "max" else np.add
    seed = np.float32(-np.inf if reduce == "max" else 0.0)

    def fin(x):
        return np.where(np.isfinite(x), x, np.float32(0)) \
            if reduce == "max" else x

    d = values.shape[1]
    out = np.full((n, d), np.nan, np.float32)
    head = np.full((len(rows) - 1, d), np.nan, np.float32)
    open_ = head.copy()
    for c, r, lo, hi, kind in steps:                   # pass 1
        acc = np.full(d, seed, np.float32)
        for k in range(lo, hi):
            acc = op(acc, vals[k])
        if kind == "direct":
            out[r] = fin(acc)
        else:
            (head if kind == "head" else open_)[c] = acc
    for c in range(len(rows) - 1):                     # pass 2
        i0, _, _, _, head_split = _bounds(indptr, rows, c, t)
        if head_split:
            first = (int(indptr[i0]) + i0) // t
            acc = open_[first]
            for k in range(first + 1, c):
                acc = op(acc, open_[k])
            out[i0] = fin(op(acc, head[c]))
    return out


def _cases():
    return [(case, t) for case in CASES for t in (16, 64, CHUNK)
            if not (case == "zipf" and t == CHUNK)] + [("zipf", CHUNK)]


@pytest.mark.parametrize("case,t", _cases())
def test_chunks_cover_every_edge_once(case, t):
    """Every edge of rows < n_nodes is walked by exactly one chunk, and no
    chunk reads an edge at or past ``indptr[n_nodes]``; no chunk walks
    more than T edges."""
    indptr, n, src = _graph(case, t, seed=t)
    _, steps = _walk(indptr, n, len(src), t)
    seen = np.zeros(max(len(src), 1), np.int64)
    per_chunk = {}
    for c, _, lo, hi, _ in steps:
        assert 0 <= lo <= hi <= indptr[n]
        seen[lo:hi] += 1
        per_chunk[c] = per_chunk.get(c, 0) + hi - lo
    assert (seen[: indptr[n]] == 1).all() and (seen[indptr[n]:] == 0).all()
    assert max(per_chunk.values(), default=0) <= t


@pytest.mark.parametrize("case,t", _cases())
def test_every_row_has_one_owner_or_one_combine(case, t):
    """Each row < n_nodes is written exactly once: directly by the chunk
    holding all of it, or by the one combine step of the chunk that
    completes it, whose partials come from consecutive chunks.  (A row
    whose first edge sits on the next chunk boundary is left open with no
    edges: the combine starts past that slot and never reads it.)"""
    indptr, n, src = _graph(case, t, seed=t + 1)
    _, steps = _walk(indptr, n, len(src), t)
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
@pytest.mark.parametrize("case,t", _cases())
def test_two_pass_emulation_matches_references(case, t, reduce, gather,
                                               integer):
    """Integer-valued rows make every fp32 sum exact, so there the split
    order must give the plain version's bits, and both references agree
    to rtol = atol = 1e-5.  Real-valued sums are held as the chip run
    holds the kernel at its main shape: |err| <= 1e-5 + 1e-5 x the sum of
    |terms| per element, since each chunk adds up to T terms serially
    (max is exact either way)."""
    indptr, n, src = _graph(case, t, seed=t + 2)
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

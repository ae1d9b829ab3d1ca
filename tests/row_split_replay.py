"""A numpy replay of the merge-path row split behind the ``spmm_csr`` and
``hadamard_spmm`` kernels, shared by their CPU tests.

``kernels/row_split.py`` builds the chunk table the CUDA kernels read;
``walk`` lists each chunk's edge ranges with the bounds of
``csrc/row_split.cuh``, and ``replay`` runs the kernels' two passes over
per-edge terms: rows that end inside a chunk are reduced and finished
directly, a row that crosses a chunk boundary leaves one partial per
chunk (the chunk's "open" slot, and a "head" slot in the chunk that
completes it), combined in chunk order and finished once.  The graphs
are seeded numpy Zipf graphs with one row spanning many chunks, rows of
T - 1, T and T + 1 edges, a row that starts exactly on a chunk boundary,
empty and trailing rows, E = 0, and an ``indptr`` longer than
``n_nodes + 1``."""
import numpy as np
import torch

from repro_torch.kernels import row_split

CASES = ("zipf", "exact", "no_edges", "long_indptr")


def boundary_degrees(t):
    """Rows of T - 1, T and T + 1 edges, empty rows, then a pad row sized
    so that the next row (3T edges) starts exactly on a chunk boundary."""
    degs = [t - 1, t, t + 1, 0, 0, 5]
    pos = sum(degs) + len(degs)        # merge position of the next row
    degs.append((-(pos + 1)) % t)      # the pad row adds pad + 1 items
    return degs + [3 * t, 1, 0, t - 1, 0, 0]


def graph(case, t, seed):
    """(indptr i64[rows + 1], n_nodes, edges' source ids in [0, 97)) for one
    case; rows >= n_nodes exist only in ``long_indptr``."""
    rng = np.random.default_rng(seed)
    if case == "zipf":
        n, e = 300, 40 * t
        dst = np.minimum(rng.zipf(1.4, e) - 1, n - 6)   # 5 trailing empty
        dst[: e // 2 + 1] = 3                           # one row > 50 % of E
        degs = np.bincount(dst, minlength=n)
    elif case == "exact":
        degs = np.array(boundary_degrees(t))
        n = len(degs)
    elif case == "no_edges":
        n = 2 * t + 3
        degs = np.zeros(n, np.int64)
    else:                                  # the caller passes fewer rows
        degs = np.array(boundary_degrees(t) + [t + 1, 7, 2 * t])
        n = len(degs) - 3
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    src = rng.integers(0, 97, int(indptr[-1])).astype(np.int32)
    assert case == "no_edges" or (degs[:n] == 0).any()
    return indptr, n, src


def cases(chunk):
    """(case, T) pairs at T in {16, 64, chunk}; the Zipf graph at the
    kernel's own chunk last."""
    return [(case, t) for case in CASES for t in (16, 64, chunk)
            if not (case == "zipf" and t == chunk)] + [("zipf", chunk)]


def bounds(indptr, rows, c, t):
    """``row_split::bounds`` of csrc/row_split.cuh."""
    i0, i1 = int(rows[c]), int(rows[c + 1])
    j0, j1 = c * t - i0, (c + 1) * t - i1
    return i0, i1, j0, j1, i0 < i1 and j0 > indptr[i0]


def walk(indptr, n, e_shape, t):
    """Each chunk's edge ranges: (chunk, row, lo, hi, kind), kind one of
    'direct', 'head', 'open', in the kernel's order."""
    rows = row_split.chunk_rows(torch.from_numpy(indptr), n, e_shape,
                                t).numpy()
    assert len(rows) == row_split.n_chunks(n, e_shape, t) + 1
    assert rows[0] == 0 and rows[-1] == n and (np.diff(rows) >= 0).all()
    steps = []
    for c in range(len(rows) - 1):
        i0, i1, j0, j1, head_split = bounds(indptr, rows, c, t)
        for r in range(i0, i1):
            lo = j0 if r == i0 else int(indptr[r])
            kind = "head" if r == i0 and head_split else "direct"
            steps.append((c, r, lo, int(indptr[r + 1]), kind))
        if i1 < n:
            steps.append((c, i1, j0 if i1 == i0 else int(indptr[i1]), j1,
                          "open"))
    return rows, steps


def replay(terms, indptr, n, e_shape, t, op, seed, finish):
    """The kernels' two passes in numpy over ``terms`` (f32[>= E, D], one
    row per edge in CSR order): per-chunk partials reduced with ``op`` from
    ``seed`` in edge order, then each split row's partials combined in
    chunk order by the chunk that completes it.  ``finish(r, acc)`` turns a
    row's complete reduction into its output (the epilogue), applied once
    per row, never to a partial."""
    rows, steps = walk(indptr, n, e_shape, t)
    d = terms.shape[1]
    out = np.full((n, d), np.nan, np.float32)
    head = np.full((len(rows) - 1, d), np.nan, np.float32)
    open_ = head.copy()
    for c, r, lo, hi, kind in steps:                   # pass 1
        acc = np.full(d, seed, np.float32)
        for k in range(lo, hi):
            acc = op(acc, terms[k])
        if kind == "direct":
            out[r] = finish(r, acc)
        else:
            (head if kind == "head" else open_)[c] = acc
    for c in range(len(rows) - 1):                     # pass 2
        i0, _, _, _, head_split = bounds(indptr, rows, c, t)
        if head_split:
            first = (int(indptr[i0]) + i0) // t
            acc = open_[first]
            for k in range(first + 1, c):
                acc = op(acc, open_[k])
            out[i0] = finish(i0, op(acc, head[c]))
    return out

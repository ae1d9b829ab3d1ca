"""Intent-weighted CSR aggregation (DGCF): out[v, chunk k] = sum over v's
edges of w[e, k] * x[src_e, chunk k].

Reads each distinct gathered row of x once, the edge indices, the
per-edge weights ([E, K] float32), the row pointers, and writes
[n_nodes, D]; a multiply and an add per edge and column.
"""
from perfbench.rooflines._program import has_op

if has_op("intent_spmm"):
    OP = "intent_spmm"


def describe(w, x, indptr, src, n_nodes, impl=None):
    d, k, e = int(x.shape[1]), int(w.shape[1]), int(src.shape[0])
    key = (src.data_ptr(), int(n_nodes), d, k, e)
    return key, (src, int(indptr.numel()), int(n_nodes), d, k)


def work(payload):
    import torch
    src, n_ptr, n, d, k = payload
    e = int(src.numel())
    rows = int(torch.unique(src).numel())
    nbytes = rows * d * 4 + e * 4 + e * k * 4 + n_ptr * 8 + n * d * 4
    return 2.0 * e * d, float(nbytes)

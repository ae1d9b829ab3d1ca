"""Fused gather-Hadamard-aggregate: out[v] = sum over v's edges of
x[x_idx_e] * y[y_idx_e].

Reads each distinct gathered row of x and of y once, the edge indices
(once where both index arrays are one tensor), the row pointers, and
writes [n_nodes, D]; a multiply and an add per edge and column.
"""
OP = "hadamard_spmm"


def describe(x, y, indptr, x_idx, y_idx, n_nodes, scale=None, slope=None,
             structure="general", impl=None):
    d = int(x.shape[1])
    key = (x_idx.data_ptr(), y_idx.data_ptr(), int(n_nodes), d,
           int(x_idx.numel()))
    return key, (x_idx, y_idx, int(indptr.numel()), int(n_nodes), d)


def work(payload):
    import torch
    x_idx, y_idx, n_ptr, n, d = payload
    same = x_idx.data_ptr() == y_idx.data_ptr()
    rows = int(torch.unique(x_idx).numel()) + int(torch.unique(y_idx).numel())
    e = int(x_idx.numel())
    nbytes = rows * d * 4 + e * 4 * (1 if same else 2) + n_ptr * 8 \
        + n * d * 4
    return 2.0 * e * d, float(nbytes)

"""CSR sum aggregation: out[v] = sum of the rows of v's edges.

With ``gather`` each edge names a source row of ``values`` ([N_src, D]);
the call reads each distinct source row once, the row pointers, the
edge indices, and writes [n_nodes, D].  Without it ``values`` holds one
row per edge ([E, D]), all read.  One add per edge and column.
"""
OP = "spmm_csr"


def describe(reduce, values, indptr, src_sorted, n_nodes, gather=False,
             impl=None):
    d = int(values.shape[1])
    e = int(src_sorted.shape[0]) if gather else int(values.shape[0])
    key = (bool(gather), int(n_nodes), d, e, int(indptr.numel()),
           src_sorted.data_ptr() if gather else 0)
    return key, (bool(gather), int(n_nodes), d, e, int(indptr.numel()),
                 src_sorted if gather else None, int(values.shape[0]))


def work(payload):
    gather, n, d, e, n_ptr, src, n_rows = payload
    if gather:
        import torch
        rows = int(torch.unique(src).numel())
        nbytes = rows * d * 4 + e * 4
    else:
        nbytes = n_rows * d * 4
    nbytes += n_ptr * 8 + n * d * 4
    return float(e) * d, float(nbytes)

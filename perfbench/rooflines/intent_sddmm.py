"""Per-edge, per-intent dots over a CSR (DGCF's agreement): s[e, k] =
<a[row_e, chunk k], b[src_e, chunk k]>.

Reads each row of a that has an edge once, each distinct gathered row of
b once, the edge indices and the row pointers, and writes the [E, K]
float32 dots; a multiply and an add per edge and column.
"""
from perfbench.rooflines._program import has_op

if has_op("intent_sddmm"):
    OP = "intent_sddmm"


def describe(a, b, indptr, src, n_factors, impl=None):
    d, e = int(a.shape[1]), int(src.shape[0])
    key = (src.data_ptr(), indptr.data_ptr(), d, int(n_factors), e)
    return key, (src, indptr, d, int(n_factors))


def work(payload):
    import torch
    src, indptr, d, k = payload
    e = int(src.numel())
    rows_a = int((indptr[1:] > indptr[:-1]).sum())
    rows_b = int(torch.unique(src).numel())
    nbytes = (rows_a + rows_b) * d * 4 + e * 4 + e * k * 4 \
        + int(indptr.numel()) * 8
    return 2.0 * e * d, float(nbytes)

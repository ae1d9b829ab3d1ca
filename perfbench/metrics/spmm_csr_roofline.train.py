"""% of the bound of the traced ``spmm_csr`` calls: the sum of each
call's least time (``rooflines/spmm_csr.py``) over the device time of
the kernels they launched."""


def read(ctx):
    return ctx.roofline("spmm_csr")

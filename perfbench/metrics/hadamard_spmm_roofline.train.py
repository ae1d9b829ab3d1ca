"""% of the bound of the traced ``hadamard_spmm`` calls
(``rooflines/hadamard_spmm.py``) over their kernels' device time."""


def read(ctx):
    return ctx.roofline("hadamard_spmm")

"""% of the bound of the traced ``intent_spmm`` calls
(``rooflines/intent_spmm.py``) over their kernels' device time."""


def read(ctx):
    return ctx.roofline("intent_spmm")

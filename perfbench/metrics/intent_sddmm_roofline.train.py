"""% of the bound of the traced ``intent_sddmm`` calls
(``rooflines/intent_sddmm.py``) over their kernels' device time."""


def read(ctx):
    return ctx.roofline("intent_sddmm")

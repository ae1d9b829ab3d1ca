"""% of the bound of the traced ``fused_topk_score`` calls
(``rooflines/fused_topk_score.py``) over their kernels' device time."""


def read(ctx):
    return ctx.roofline("fused_topk_score")

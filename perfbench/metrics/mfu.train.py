"""% of the card's float32 peak: the model FLOPs of the window's steps
(``rooflines/<arch>_train_step.py``) over the window times 66.9 TFLOP/s."""
from perfbench.rooflines.peaks import PEAK_FP32


def read(ctx):
    if ctx.window_s <= 0 or ctx.flops <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * PEAK_FP32)

"""% of the card's float32 peak: the scoring FLOPs of the window's
answered requests (2 x items x D each) over the window times 66.9
TFLOP/s."""
from perfbench.rooflines.peaks import PEAK_FP32


def read(ctx):
    if ctx.window_s <= 0 or ctx.flops <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * PEAK_FP32)

"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3), dense, without
sparsity, at the 700 W limit: NVIDIA's data sheet, as the program's
``launch/roofline.py`` states them."""
HBM_BW = 3.35e12             # bytes/s
PEAK_FP32 = 66.9e12          # FLOP/s, float32 outside the tensor cores
PEAK_BF16 = 989.4e12         # FLOP/s, dense bf16 tensor cores


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(nbytes / HBM_BW, flops / PEAK_FP32)

"""NaN and infinite top-K cases shared by the CPU tests against the
reference (``test_torch_topk_nan.py``) and the card's kernel test
(``test_torch_cuda.py``), without JAX: the card's machine has none.  Not a
test file.

Every dot product of the fused cases meets at most one NaN payload (an
input's, or the one x86 makes of inf - inf), so the result does not
depend on the order in which a package sums it.
"""
import numpy as np

BITS = {"+nan": 0x7FC00000, "+nan_payload": 0x7FC00123,
        "-nan": 0xFFC00000, "-nan_payload": 0xFFC00456,
        "+inf": 0x7F800000, "-inf": 0xFF800000}


def nan_bits(name):
    """The float32 whose bits BITS names."""
    return np.array([BITS[name]], np.uint32).view(np.float32)[0]


def fused_case(case, rng):
    """(ue, table, seen, mask, k, n_items): integer-valued finite rows with
    NaN and infinite rows mixed in, over several item blocks."""
    b, n, d, k, L = 9, 40, 8, 12, 5
    ue = rng.integers(1, 4, (b, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (n, d)).astype(np.float32)
    if case == "nan_items":                    # one NaN entry a row
        for r, name in zip(range(0, n, 3), ["+nan", "-nan", "+nan_payload",
                                            "-nan_payload"] * 4):
            ie[r, r % d] = nan_bits(name)
    elif case == "inf_items":                  # ±inf under positive users
        ie[::4] = nan_bits("+inf")
        ie[2::4] = nan_bits("-inf")
    elif case == "inf_minus_inf":              # x86's default NaN, -NaN
        ie[1::5] = nan_bits("+inf")
        ue[:, 0] = -ue[:, 0]
    elif case == "nan_users":                  # a whole user row of NaN
        ue[1] = nan_bits("+nan")
        ue[4] = nan_bits("-nan")
    elif case == "mixed":
        ie[0::7, 0] = nan_bits("-nan")
        ie[3::7, 1] = nan_bits("+nan")
        ie[5::7] = nan_bits("+inf")
        ie[6::7] = nan_bits("-inf")
        k = 30
    seen = rng.integers(0, n, (b, L)).astype(np.int32)
    mask = rng.random((b, L)) < 0.5
    return ue, ie, seen, mask, k, n


CASES = ["nan_items", "inf_items", "inf_minus_inf", "nan_users", "mixed"]

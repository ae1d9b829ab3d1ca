"""The plain reference that decides ``correct``.

Plain PyTorch over the generator's edge arrays, float32 with TF32 off
unless a control asks for a lower precision.  It imports nothing of the
program and takes nothing the program made: it works out the degrees,
the initial weights, the BPR batches and every step again from the edge
arrays, the configuration and ``--seed``.  One module per architecture
(``<arch>.py``: ``init`` and ``forward``), found by the configuration's
``arch``; ``graph`` holds the propagation, ``train`` the BPR steps and
``topk`` the seen-masked top-K.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

# precisions a run of the reference can be asked for: the configuration's
# own, and the controls one step below it
PRECISIONS = ("float32", "tf32", "bfloat16")


def model(arch: str):
    """The reference module of one architecture (``reference/<arch>.py``)."""
    return importlib.import_module(f"{__name__}.{arch}")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


@contextlib.contextmanager
def precision(name: str):
    """TF32 matmuls on for 'tf32' and off otherwise, restored on exit."""
    dtype_of(name)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old

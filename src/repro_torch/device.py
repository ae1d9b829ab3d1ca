"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``; asking for CUDA where there is
no card raises instead of quietly running on the CPU.  Tests pass
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch route")
    return dev


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (no copy when it
    already lies there with that dtype)."""
    if isinstance(x, np.ndarray):
        if not (x.flags.writeable and x.flags.c_contiguous):
            x = np.array(x)              # torch wants a writable buffer
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device=device, dtype=dtype)

"""Weights across: the reference's params as numpy arrays -> the port's
tensors, so both packages can run from one state."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(params: dict, device="cuda") -> dict[str, torch.Tensor]:
    """{'user_embed', 'item_embed', ...} of numpy arrays (e.g.
    ``{k: np.asarray(v) for k, v in run.params.items()}``) -> float32
    tensors on ``device``.  Only array leaves are taken (LightGCN's)."""
    dev = resolve_device(device)
    out = {}
    for name, value in params.items():
        arr = np.asarray(value)
        if arr.dtype.kind != "f":
            raise TypeError(f"param {name!r} is not a float array "
                            f"(dtype {arr.dtype})")
        out[name] = torch.from_numpy(np.array(arr, np.float32)).to(dev)
    return out

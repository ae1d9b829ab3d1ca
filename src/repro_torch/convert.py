"""Weights across: the reference's params as numpy arrays -> the port's
tensors and back, so both packages can run from one state."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(params, device="cuda"):
    """Nested dicts and lists of float arrays (e.g. the reference's
    ``pipe.init_state()["params"]`` through ``np.asarray``) -> the same
    structure of float32 tensors on ``device``.  NGCF's ``w1``/``w2``
    lists and GCN's ``layers`` list of dicts keep their layout."""
    dev = resolve_device(device)

    def leaf(path, value):
        arr = np.asarray(value)
        if arr.dtype.kind != "f":
            raise TypeError(f"param {path!r} is not a float array "
                            f"(dtype {arr.dtype})")
        return torch.from_numpy(np.array(arr, np.float32)).to(dev)

    def walk(path, value):
        if isinstance(value, dict):
            return {k: walk(f"{path}.{k}" if path else k, v)
                    for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [walk(f"{path}[{i}]", v) for i, v in enumerate(value)]
        return leaf(path, value)

    return walk("", params)


def params_to_numpy(params):
    """The inverse: nested dicts and lists of tensors -> numpy arrays in
    the same structure (host copies)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()

"""Weights across: the reference's params as numpy arrays -> the port's
tensors and back, so both packages can run from one state."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(params, device="cuda"):
    """Nested dicts and lists of float arrays (e.g. the reference's
    ``pipe.init_state()["params"]`` through ``np.asarray``) -> the same
    structure of tensors on ``device``: bfloat16 leaves as
    ``torch.bfloat16`` (the same bits), every other float leaf as float32.
    NGCF's ``w1``/``w2`` lists, GCN's ``layers`` list of dicts and the
    transformer's stacked ``layers`` keep their layout.

    A JAX bfloat16 array comes through ``np.asarray`` as ``ml_dtypes``'
    bfloat16, of dtype kind ``'V'``; its bits are read through ``int16``,
    so this needs no ``ml_dtypes`` (the card's machine has none)."""
    dev = resolve_device(device)

    def leaf(path, value):
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
            bits = np.ascontiguousarray(arr).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
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
    the same structure (host copies).  A bfloat16 leaf comes back as
    float32 (exact: every bfloat16 is a float32), since numpy has no
    bfloat16 of its own."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()

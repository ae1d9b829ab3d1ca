"""Int8 row storage for capacity-tier tables (the storage half of
``repro/optim/compression.py``; gradient compression is ROADMAP A9).

The functions are numpy on the host, copied from the reference, so a table
quantized by either package stores the same bytes."""
from __future__ import annotations

import numpy as np


def quantize_rows_int8(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8, deterministic round-to-nearest.  Returns
    (q [N, D] int8, scale [N, 1] float32); the reconstruction error is at
    most scale/2 per element."""
    table = np.asarray(table, np.float32)
    scale = (np.abs(table).max(axis=-1, keepdims=True) / 127.0
             + 1e-12).astype(np.float32)
    q = np.clip(np.rint(table / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_rows_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale

"""Architecture registry (the port of ``repro/configs``): one module per
assigned arch (+ the paper's own NGCF/LightGCN).  ``get(arch_id)``
returns the module, which exposes FULL, SMOKE, FAMILY, OPTIMIZER, SHAPES
and SKIP (and family-specific extras)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "nemotron_4_340b", "gemma2_2b", "granite_3_8b", "mixtral_8x7b",
    "kimi_k2_1t_a32b", "gcn_cora", "deepfm", "xdeepfm", "bert4rec",
    "dlrm_rm2", "ngcf", "lightgcn",
]

ASSIGNED = ARCH_IDS[:10]          # graded pool
PAPER_OWN = ARCH_IDS[10:]         # the paper's own models


def canon(arch_id: str) -> str:
    return arch_id.replace("-", "_")


def get(arch_id: str):
    name = canon(arch_id)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")

"""Architecture registry (the port of ``repro/configs``): the paper's own
two architectures, NGCF and LightGCN.  ``get(arch_id)`` returns the
module, which exposes FULL, SMOKE, FAMILY and OPTIMIZER.  The
reference's other architectures (the LM and CTR model pool) are ROADMAP
A12; asking for one raises ``KeyError`` naming it."""
from __future__ import annotations

import importlib

ARCH_IDS = ["ngcf", "lightgcn"]
# the reference's registry beyond the paper's own models (ROADMAP A12)
UNPORTED = ["nemotron_4_340b", "gemma2_2b", "granite_3_8b", "mixtral_8x7b",
            "kimi_k2_1t_a32b", "gcn_cora", "deepfm", "xdeepfm", "bert4rec",
            "dlrm_rm2"]


def canon(arch_id: str) -> str:
    return arch_id.replace("-", "_")


def get(arch_id: str):
    name = canon(arch_id)
    if name in UNPORTED:
        raise KeyError(f"arch {arch_id} is not ported yet (ROADMAP A12, the "
                       f"model pool); ported: {ARCH_IDS}")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")

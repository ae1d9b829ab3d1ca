"""Architecture registry (the port of ``repro/configs``): the paper's own
NGCF and LightGCN, GCN and the CTR and sequential recommenders.
``get(arch_id)`` returns the module, which exposes FULL, SMOKE, FAMILY
and OPTIMIZER (and family-specific extras).  The reference's LM pool is
ROADMAP A12b; asking for one of its archs raises ``KeyError`` naming it."""
from __future__ import annotations

import importlib

ARCH_IDS = ["gcn_cora", "deepfm", "xdeepfm", "bert4rec", "dlrm_rm2", "ngcf",
            "lightgcn"]
# the reference's LM pool (ROADMAP A12b)
UNPORTED = ["nemotron_4_340b", "gemma2_2b", "granite_3_8b", "mixtral_8x7b",
            "kimi_k2_1t_a32b"]


def canon(arch_id: str) -> str:
    return arch_id.replace("-", "_")


def get(arch_id: str):
    name = canon(arch_id)
    if name in UNPORTED:
        raise KeyError(f"arch {arch_id} is not ported yet (ROADMAP A12b, the "
                       f"LM pool); ported: {ARCH_IDS}")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")

"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version (``ref``), routed by ``ops``."""
from __future__ import annotations

from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.hadamard_spmm import hadamard_spmm_cuda
from repro_torch.kernels.spmm import spmm_csr_cuda
from repro_torch.kernels.topk_score import fused_topk_score_cuda

WRAPPERS = {
    "spmm_csr": spmm_csr_cuda,
    "embedding_bag": embedding_bag_cuda,
    "fused_topk_score": fused_topk_score_cuda,
    "hadamard_spmm": hadamard_spmm_cuda,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0

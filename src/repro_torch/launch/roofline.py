"""Roofline terms for a cell on a mesh of H100s (the port of
``repro/launch/roofline.py``):

  compute term    = FLOPs / (chips * peak FLOP/s of the dtype)
  memory term     = HBM bytes / (chips * HBM bytes/s)
  collective term = collective bytes / (chips * NVLink bytes/s)

The reference reads FLOPs and bytes from a compiled program's
``cost_analysis()`` and collective bytes from its HLO text.  An eager
program has neither, so ``analyze`` takes the three counts as numbers,
and ``collective_bytes`` sums the payloads of the c10d ops that the step
auditor (``analysis/step_audit.py``) records.

The card's figures are NVIDIA's H100 SXM5 data sheet (dense, without
sparsity, at the 700 W limit), the NVIDIA H100 80GB HBM3 part.  NVLink 4
is 900 GB/s per card in both directions together, 450 GB/s each way; it
is the upper bound for a mesh that spans nodes, whose links between
nodes are slower.
"""
from __future__ import annotations

import dataclasses

import torch

PEAK_BF16 = 989.4e12         # FLOP/s, dense bf16 tensor cores (data sheet)
PEAK_FP32 = 66.9e12          # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s per direction per card, NVLink 4
HBM_BYTES = 80e9             # bytes of HBM per card

PEAK_FLOPS = {"bfloat16": PEAK_BF16, "float32": PEAK_FP32}

# c10d op (the name after ``c10d.``) -> the reference's collective kind
C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


def shape_bytes(dtype: torch.dtype, shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_kind: dict

    def __str__(self):
        parts = ", ".join(f"{k}: {v/1e9:.3f} GB" for k, v in
                          sorted(self.by_kind.items()))
        return f"collectives {self.total_bytes/1e9:.3f} GB ({parts})"


def collective_bytes(records) -> CollectiveStats:
    """Payload bytes of the recorded collectives, by kind: the largest
    tensor each op names (the buffer that crosses the links), as the
    reference takes the largest shape of each HLO collective.  A record
    is an ``analysis.step_audit.OpRecord``: its ``name`` and its tensors'
    (dtype, shape)."""
    total = 0
    by_kind: dict[str, int] = {}
    for r in records:
        kind = C10D_KINDS.get(r.name.split(".")[1]) \
            if r.name.startswith("c10d.") else None
        if kind is None or not r.tensors:
            continue
        b = max(shape_bytes(dt, shape) for dt, shape in r.tensors)
        total += b
        by_kind[kind] = by_kind.get(kind, 0) + b
    return CollectiveStats(total, by_kind)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(flops: float, hbm_bytes: float, coll_bytes: float, n_chips: int,
            model_flops: float = 0.0, *, peak_flops: float = PEAK_BF16,
            hbm_bw: float = HBM_BW, link_bw: float = NVLINK_BW
            ) -> Roofline:
    """The three terms and the bottleneck, the largest of them.  The
    peaks default to the H100's; ``peak_flops`` is the cell's dtype's
    (``PEAK_FLOPS``)."""
    flops, byts, coll = float(flops), float(hbm_bytes), float(coll_bytes)
    compute_s = flops / (n_chips * peak_flops)
    memory_s = byts / (n_chips * hbm_bw)
    collective_s = coll / (n_chips * link_bw)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(flops, byts, coll, n_chips, compute_s, memory_s,
                    collective_s, bottleneck, model_flops,
                    (model_flops / flops) if flops else 0.0)

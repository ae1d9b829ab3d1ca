"""Work counts on hand-counted tiny graphs."""
import torch

from perfbench import rooflines
from perfbench.rooflines import (fused_topk_score, hadamard_spmm,
                                 lightgcn_train_step, ngcf_train_step, peaks,
                                 spmm_csr)

# 3 dst rows, 4 edges, sources {0, 2} of 5 rows, D = 2
INDPTR = torch.tensor([0, 2, 2, 4])
SRC = torch.tensor([0, 2, 2, 0], dtype=torch.int32)


def test_spmm_csr_gather():
    values = torch.zeros(5, 2)
    key, payload = spmm_csr.describe("sum", values, INDPTR, SRC, 3,
                                     gather=True)
    flops, nbytes = spmm_csr.work(payload)
    assert flops == 4 * 2
    # 2 distinct rows x 2 x 4 B + 4 indices x 4 B + 4 pointers x 8 B
    # + 3 x 2 x 4 B written
    assert nbytes == 16 + 16 + 32 + 24


def test_spmm_csr_edge_values():
    values = torch.zeros(4, 2)
    _, payload = spmm_csr.describe("sum", values, INDPTR, SRC, 3)
    assert spmm_csr.work(payload) == (8.0, float(4 * 2 * 4 + 32 + 24))


def test_hadamard_spmm():
    x, y = torch.zeros(5, 2), torch.zeros(3, 2)
    dst = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    _, payload = hadamard_spmm.describe(x, y, INDPTR, SRC, dst, 3)
    flops, nbytes = hadamard_spmm.work(payload)
    assert flops == 2 * 4 * 2
    # rows: x {0, 2} + y {0, 2} = 4 x 8 B; two index arrays 32 B;
    # pointers 32 B; output 24 B
    assert nbytes == 32 + 32 + 32 + 24


def test_fused_topk_score():
    ue = torch.zeros(4, 8)
    table = torch.zeros(100, 8)
    seen = torch.zeros(4, 3, dtype=torch.int32)
    _, payload = fused_topk_score.describe(ue, table, seen, seen.bool(),
                                           k=5, n_items=100)
    flops, nbytes = fused_topk_score.work(payload)
    assert flops == 2 * 4 * 100 * 8
    assert nbytes == 100 * 8 * 4 + 4 * 8 * 4 + 4 * 3 * 5 + 4 * 5 * 8


def test_bound_is_the_larger_term():
    assert peaks.bound_s(0.0, peaks.HBM_BW) == 1.0
    assert peaks.bound_s(peaks.PEAK_FP32, 0.0) == 1.0


def test_gnn_step_counts():
    # LightGCN, 1 layer, U = I = 1, E = 1, D = 1, B = 1:
    # linear = 1 x (2 + 4) + 2 x 2 = 10 -> 20; BPR 30; Adam 12 x 2
    assert lightgcn_train_step.flops(1, 1, 1, 1, 1, 1) == 20 + 30 + 24
    # NGCF, 1 layer: linear 2 + 4 = 6 -> 12; products 2 + 16 = 18 -> 54;
    # BPR on F = 2: 60; params 2 + 2 = 4 -> 48
    assert ngcf_train_step.flops(1, 1, 1, 1, 1, 1) == 12 + 54 + 60 + 48


def test_every_work_count_names_an_operation_of_the_program():
    from repro_torch.kernels import ops
    for name in rooflines.names():
        assert callable(getattr(ops, rooflines.module(name).OP))


def test_every_training_config_finds_its_step_count():
    from perfbench.harness import bench
    for c in bench.load_json(bench.ROOT / "BENCHMARK.json")["configs"]:
        arch = bench.load_json(bench.ROOT / c["file"])["arch"]
        assert callable(rooflines.module(f"{arch}_train_step").flops)

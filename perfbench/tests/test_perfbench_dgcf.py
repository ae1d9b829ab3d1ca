"""The ``dgcf-train-device`` cell: its files resolve by name, its constants
agree with the program and the reference, its work counts hold on a
hand-counted graph, and a whole run at a CPU size is correct while its
faults and its control are not."""
import ast
import contextlib
import functools
import pathlib

import pytest
import torch

from perfbench import rooflines
from perfbench import run as bench_run
from perfbench.harness import bench, check, control
from perfbench.reference import dgcf as ref_dgcf
from perfbench.rooflines import (dgcf_train_step, intent_sddmm, intent_spmm,
                                 lightgcn_train_step)
from perfbench.rooflines._program import has_op
from perfbench.tests.tiny import tiny

CELL = "dgcf-train-device"
SEED = 2**31 + 33033
METRICS = ("intent_spmm_roofline.train", "intent_sddmm_roofline.train",
           "routing_device_share.train")


def test_the_cell_resolves_to_its_files():
    cell = bench.resolve(CELL)
    assert cell.kind == "train" and cell.chips == 1
    assert cell.config["name"] == "dgcf-full" and cell.config["arch"] == "dgcf"
    assert cell.limits["control"] == "bfloat16"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "train_samples_per_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(METRICS) <= names
    assert {"engine_step_ms.train", "loop_overhead_share.train",
            "device_idle_share.train", "mfu.train"} <= names
    for name in names:
        assert callable(bench.metric_reader(name))
    assert callable(rooflines.module("dgcf_train_step").flops)
    assert {"intent_spmm", "intent_sddmm"} <= set(rooflines.names())


def test_the_published_setting_is_one_across_the_files():
    from repro_torch.core import dgcf
    from repro_torch.pipeline.registry import get_model
    cfg = bench.resolve(CELL).config
    want = (cfg["n_factors"], cfg["n_iterations"])
    assert want == (4, 2) == (cfg["published"]["n_factors"],
                              cfg["published"]["n_iterations"])
    assert (ref_dgcf.N_FACTORS, ref_dgcf.N_ITERATIONS) == want
    assert (dgcf_train_step.N_FACTORS, dgcf_train_step.N_ITERATIONS) == want
    assert (dgcf.N_FACTORS, dgcf.N_ITERATIONS) == want
    assert get_model("dgcf").forward.keywords == \
        {"n_factors": want[0], "n_iterations": want[1]}
    assert cfg["embed_dim"] == cfg["overrides"]["model.embed_dim"] == 64
    assert cfg["n_layers"] == cfg["overrides"]["model.n_layers"] == 1


def test_the_reference_imports_nothing_of_the_program():
    path = pathlib.Path(ref_dgcf.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "torch", "perfbench"}, names


# 3 rows, 4 edges into rows {0, 2}, sources {0, 2} of 5 rows, D = 4, K = 2
INDPTR = torch.tensor([0, 2, 2, 4])
SRC = torch.tensor([0, 2, 2, 0], dtype=torch.int32)


def test_intent_spmm_work():
    w, x = torch.zeros(4, 2), torch.zeros(5, 4)
    _, payload = intent_spmm.describe(w, x, INDPTR, SRC, 3)
    flops, nbytes = intent_spmm.work(payload)
    assert flops == 2 * 4 * 4
    # 2 distinct rows x 4 x 4 B + 4 indices x 4 B + 4 x 2 weights x 4 B
    # + 4 pointers x 8 B + 3 x 4 x 4 B written
    assert nbytes == 32 + 16 + 32 + 32 + 48


def test_intent_sddmm_work():
    a, b = torch.zeros(3, 4), torch.zeros(5, 4)
    _, payload = intent_sddmm.describe(a, b, INDPTR, SRC, 2)
    flops, nbytes = intent_sddmm.work(payload)
    assert flops == 2 * 4 * 4
    # rows of a with an edge {0, 2} + rows of b {0, 2}: 4 x 16 B;
    # indices 16 B; 4 x 2 dots written 32 B; pointers 32 B
    assert nbytes == 64 + 16 + 32 + 32


def test_dgcf_step_count():
    # U = I = 1 (N = 2), E = 1, D = 1, B = 1, L = 1, K = 4, T = 2:
    # route = 2 (16 + 2) + 2·4 + 2·2 = 48; agree = 2 (2 + 4) + 6 = 18;
    # forward = 2·48 + 8 (tanh) + 18 (one agreement) + 2·2 (mean) = 126
    assert dgcf_train_step.flops(1, 1, 1, 1, 1, 1) == 3 * 126 + 30 + 24
    # no layers: the mean of x^(0) alone, BPR and Adam, as LightGCN's
    assert dgcf_train_step.flops(3, 4, 9, 8, 0, 5) == \
        lightgcn_train_step.flops(3, 4, 9, 8, 0, 5) + 7 * 8


def test_work_counts_name_an_operation_only_where_the_program_has_it():
    assert has_op("intent_spmm") and has_op("intent_sddmm")
    assert not has_op("no_such_operation")
    assert intent_spmm.OP == "intent_spmm" and intent_sddmm.OP == "intent_sddmm"


def _run(trace=False, cell=None):
    return bench_run.run_cell(CELL, SEED, 0.3, trace, "cpu",
                              cell=cell or tiny(CELL))


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    res = _run(trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@contextlib.contextmanager
def _replaced(obj, name, make):
    """``obj.name`` replaced by ``make(obj.name)``: a class's method, or a
    field of the registry's ``ModelSpec``, a frozen dataclass."""
    put = setattr if isinstance(obj, type) else object.__setattr__
    orig = getattr(obj, name)
    put(obj, name, make(orig))
    try:
        yield
    finally:
        put(obj, name, orig)


def _unchanged_state(orig):
    def step_fn(self, state, step):
        _, loss = orig(self, state, step)
        return state, loss
    return step_fn


def _half_batch(orig):
    def next_target_batch(self, k, step):
        users, pos, neg = orig(self, k, step)
        h = len(users) // 2
        return users[:h], pos[:h], neg[:h]
    return next_target_batch


def _one_iteration(orig):
    """The routing cut to one iteration: LightGCN's layer."""
    return functools.partial(orig, n_iterations=1)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "one_iteration"])
def test_fault_is_caught(fault):
    from repro_torch.pipeline.engine import Pipeline
    from repro_torch.pipeline.registry import MODELS
    obj, name, make = {
        "unchanged_state": (Pipeline, "step_fn", _unchanged_state),
        "half_batch": (Pipeline, "_next_target_batch", _half_batch),
        "one_iteration": (MODELS["dgcf"], "forward", _one_iteration),
    }[fault]
    with _replaced(obj, name, make):
        res = _run()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_bfloat16_control_fails(seed):
    from perfbench.tools.calibrate import program_run
    cell = tiny(CELL)
    inputs, _, _, end = program_run(cell, seed, "cpu")
    numbers = control.train_numbers(cell, inputs, seed, "cpu", end)
    assert set(numbers) == set(cell.limits["numbers"])
    ok, checks = check.judge(numbers, cell.limits)
    assert not ok, checks

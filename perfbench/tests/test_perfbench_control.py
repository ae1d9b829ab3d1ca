"""The control of ``correct`` (the reference one precision below the
configuration's, in the program's place) fails the limits, at a size a
test holds.  bfloat16 runs on the CPU; TF32 exists only on the card."""
import numpy as np
import pytest

from perfbench.harness import check, control, program, serve
from perfbench.tests.tiny import tiny

SEEDS = [2**31 + 1, 2**31 + 2, 2**31 + 3]


def _train(workload, seed, device):
    """The control's numbers, the end steps' from a sound program's state
    at the end of a one-epoch window (every number the limits name)."""
    from perfbench.tools.calibrate import program_run
    cell = tiny(workload)
    inputs, _, _, end = program_run(cell, seed, device)
    numbers = control.train_numbers(cell, inputs, seed, device, end)
    assert set(numbers) == set(cell.limits["numbers"])
    return check.judge(numbers, cell.limits)


def _serve(workload, seed, device):
    cell = tiny(workload)
    inputs = program.make_inputs(cell.config, seed, device)
    deg = np.bincount(inputs.train_user, minlength=inputs.n_users)
    popular = np.lexsort((np.arange(inputs.n_users), -deg))
    cell.mix["rate_per_s"] = 2000.0
    _, users = serve.arrivals(cell.mix, 1.0, popular, seed, 2)
    numbers = control.serve_numbers(cell, inputs, seed, device,
                                    users.astype(np.int64), cell.mix["k"])
    numbers["unanswered"] = 0.0          # the control answers every one
    assert set(numbers) == set(cell.limits["numbers"])
    return check.judge(numbers, cell.limits)


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_control_fails_lightgcn_training(seed):
    ok, checks = _train("lightgcn-train-device", seed, "cpu")
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_fails_ngcf_training(seed, cuda_device):
    ok, checks = _train("ngcf-train-device", seed, cuda_device)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_fails_serving(seed, cuda_device):
    ok, checks = _serve("lightgcn-serve-zipf", seed, cuda_device)
    assert not ok, checks

"""Whole runs of each cell at a CPU size, past the look for a card: a
sound program is correct, and each fault a cell can have, planted under
the timed path, makes ``correct`` come out false: from the first step,
and in training also from the window's first step on alone (a fault of
the steady state, which the first steps cannot see)."""
import contextlib

import numpy as np
import pytest

from perfbench import run as bench_run
from perfbench.tests.tiny import tiny

TRAIN = ["lightgcn-train-device", "ngcf-train-device",
         "lightgcn-train-hosttables"]
SERVE = ["lightgcn-serve-zipf"]
SEED = 2**31 + 12345
WINDOW_STEP = 4          # the mixes' follow_steps + warm_steps


def _run(workload, trace=False):
    return bench_run.run_cell(workload, SEED, 0.3, trace, "cpu",
                              cell=tiny(workload))


@contextlib.contextmanager
def _patched(cls, name, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


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


def _stale_batch(orig):
    def next_target_batch(self, k, step):
        batch = orig(self, k, step)
        self.__dict__.setdefault("_stale", batch)
        return self._stale
    return next_target_batch


def _from_window(make):
    """The fault of ``make`` from the window's first step on: set-up's
    steps run sound."""
    def wrap(orig):
        faulty = make(orig)

        def method(self, *args):
            step = args[-1]
            return (faulty if step >= WINDOW_STEP else orig)(self, *args)
        return method
    return wrap


def _altered_answer(orig):
    def recommend(self, user_ids, k=None, exclude_seen=True):
        ids, scores = orig(self, user_ids, k=k, exclude_seen=exclude_seen)
        ids = np.array(ids)
        ids[0, 0] = (ids[0, 0] + 1) % self.n_items
        return ids, scores
    return recommend


def _half_answered(orig):
    def run_batch(self, batch):
        out = orig(self, batch)
        return out[:max(1, len(out) // 2)] if len(out) > 1 else out
    return run_batch


@pytest.mark.parametrize("workload", TRAIN + SERVE)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    res = _run(workload, trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_fault_is_caught(workload, fault):
    from repro_torch.pipeline.engine import Pipeline
    name, make = {"unchanged_state": ("step_fn", _unchanged_state),
                  "half_batch": ("_next_target_batch", _half_batch)}[fault]
    with _patched(Pipeline, name, make):
        res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "stale_batch"])
def test_training_fault_in_the_window_alone_is_caught(workload, fault):
    from repro_torch.pipeline.engine import Pipeline
    cell = tiny(workload)
    assert WINDOW_STEP == cell.mix["follow_steps"] + cell.mix["warm_steps"]
    name, make = {"unchanged_state": ("step_fn", _unchanged_state),
                  "half_batch": ("_next_target_batch", _half_batch),
                  "stale_batch": ("_next_target_batch", _stale_batch)}[fault]
    with _patched(Pipeline, name, _from_window(make)):
        res = bench_run.run_cell(workload, SEED, 0.3, False, "cpu", cell=cell)
    checks = res["checks"]
    assert not res["correct"], checks
    # the first steps ran sound: the end steps caught it
    assert all(checks[n]["value"] <= checks[n]["limit"]
               for n in ("loss_gap", "grad_gap", "update_gap"))


@pytest.mark.parametrize("fault", ["altered_answer", "half_answered"])
def test_serving_fault_is_caught(fault):
    from repro_torch.eval.recommender import Recommender
    from repro_torch.serving.service import RecommenderService
    cls, name, make = {
        "altered_answer": (Recommender, "recommend", _altered_answer),
        "half_answered": (RecommenderService, "_run_batch", _half_answered),
    }[fault]
    cell = tiny(SERVE[0])
    cell.mix["drain_seconds"] = 0.5
    with _patched(cls, name, make):
        res = bench_run.run_cell(SERVE[0], SEED, 0.3, False, "cpu", cell=cell)
    assert not res["correct"], res["checks"]

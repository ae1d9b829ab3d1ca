"""Ambient sharding hints (the port of ``repro/dist/hints.py``).

The engine installs hints around each step of a sharded run:

    with sharding_hints(dp=shard.dp, group=group):
        state, loss = pipeline.step_fn(state, step)

so code inside can read the data-parallel axis name and the process group
(``get_hints``) without threading them through every call.  The
reference's ``constrain`` pins an intermediate's sharding for GSPMD;
PyTorch has no GSPMD — each rank holds what its code computes — so here
``constrain`` is the identity, kept so model code reads the same in both
packages.

Labels: ``None`` (unconstrained dim), ``"dp"``, ``"tp"``, or ``"dp+tp"``.
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def get_hints() -> dict | None:
    """The active hint dict ({'dp': ..., 'tp': ..., 'group': ...}) or
    None."""
    return getattr(_STATE, "hints", None)


@contextlib.contextmanager
def sharding_hints(dp=None, tp=None, group=None):
    """Install dp/tp axis-name hints and the run's process group for the
    enclosed region (nested regions restore the outer hints on exit)."""
    prev = get_hints()
    _STATE.hints = {"dp": dp, "tp": tp, "group": group}
    try:
        yield
    finally:
        _STATE.hints = prev


def constrain(x, *labels):
    """The reference's sharding pin: the identity here (no GSPMD)."""
    del labels
    return x

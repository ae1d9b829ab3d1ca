"""Work counts: the operations and bytes one operation's call must do,
computed from its inputs, whatever implements it.

One module per operation of the program's kernel dispatch
(``repro_torch.kernels.ops``), named as the operation, with

    OP = "<name in repro_torch.kernels.ops>"
    describe(*args, **kwargs) -> (key, payload)   # at call time: no sync
    work(payload) -> (flops, bytes)               # after the window

``describe`` keeps what ``work`` needs (shapes, index tensors); calls
with the same key do the same work and are counted once.  Bytes count
each input byte read once and each output byte written once; where the
work depends on the data (which rows a sparse product gathers), it is
what these inputs need.  Whole-step counts that are no single operation
(``<arch>_train_step``, one file per model) define ``flops`` and no
``OP``.  ``peaks`` holds the
card's published rates.
"""
import importlib
import pathlib

DIR = pathlib.Path(__file__).resolve().parent


def names() -> list[str]:
    """Every operation with a work count (its module defines ``OP``)."""
    out = []
    for p in sorted(DIR.glob("*.py")):
        if p.stem.startswith("_"):
            continue
        mod = importlib.import_module(f"{__name__}.{p.stem}")
        if hasattr(mod, "OP"):
            out.append(p.stem)
    return out


def module(name: str):
    return importlib.import_module(f"{__name__}.{name}")

"""Whether the program under test has an operation of its kernel dispatch
(``repro_torch.kernels.ops``): a work count names its ``OP`` only then, so
the traced run of a program that predates the operation records what it
has, and that count reads nothing."""


def has_op(name: str) -> bool:
    try:
        from repro_torch.kernels import ops
    except ImportError:
        return False
    return callable(getattr(ops, name, None))

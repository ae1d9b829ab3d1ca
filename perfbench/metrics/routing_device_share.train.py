"""% of the traced device-busy time spent in DGCF's two routing operations:
the device time of the kernels launched inside the ``intent_spmm`` and
``intent_sddmm`` ranges over the union of device activity in the window.
Nothing where the trace saw neither."""

OPS = ("intent_spmm", "intent_sddmm")


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    found = [ctx.trace.op_s[op] for op in OPS if op in ctx.trace.op_s]
    if not found:
        return None
    return 100.0 * sum(found) / ctx.trace.busy_s

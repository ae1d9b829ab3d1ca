"""Device ms of host-device copies per step in the traced phase
(``Memcpy`` activity in the profiler trace).  Nothing to read where no
leaf is demoted."""


def read(ctx):
    if ctx.trace is None or not ctx.counters.get("tiers_used") \
            or ctx.trace_work == 0 or ctx.trace.copy_s <= 0:
        return None
    return 1e3 * ctx.trace.copy_s / ctx.trace_work

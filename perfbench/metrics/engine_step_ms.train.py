"""Mean ms of the harness's spans around ``Pipeline.step_fn`` in the
window (each span ends with a device synchronisation)."""


def read(ctx):
    if not ctx.spans:
        return None
    return 1e3 * sum(b - a for a, b in ctx.spans) / len(ctx.spans)

"""% of the training window outside the harness's spans around
``Pipeline.step_fn``: the API and loop's own time (``Run.fit``,
``run_training``) and the host gaps between steps."""


def read(ctx):
    if not ctx.spans or ctx.window_s <= 0:
        return None
    inside = sum(b - a for a, b in ctx.spans)
    return 100.0 * (1.0 - inside / ctx.window_s)

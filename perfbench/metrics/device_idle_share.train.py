"""% of the traced window in which no kernel or copy ran on the card
(1 - the union of device activity over the window)."""


def read(ctx):
    return None if ctx.trace is None else 100.0 * ctx.trace.idle_share

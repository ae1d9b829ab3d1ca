"""MB a step moved over the host link: the program's own counter,
``TieredExecutor.link_bytes`` (h2d + d2h), over the window's steps.
Nothing to read where no leaf is demoted (the tiers are bypassed)."""


def read(ctx):
    c = ctx.counters
    moved = c.get("link_h2d", 0) + c.get("link_d2h", 0)
    if not c.get("tiers_used") or ctx.work == 0 or moved == 0:
        return None
    return moved / ctx.work / 1e6

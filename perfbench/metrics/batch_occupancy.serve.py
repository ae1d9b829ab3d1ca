"""% of a dispatched batch's bucket that real requests filled, mean
over the window: ``RequestQueue.stats()['mean_occupancy']``."""


def read(ctx):
    s = ctx.counters.get("service")
    if not s or not s["batches"]:
        return None
    return 100.0 * s["mean_occupancy"]

"""Median ms of a batch's service (gather, score, top-K and the copy to
the host) over the window: ``RecommenderService.stats()
['service_p50_us']``."""


def read(ctx):
    s = ctx.counters.get("service")
    if not s or not s["completed"]:
        return None
    return s["service_p50_us"] / 1e3

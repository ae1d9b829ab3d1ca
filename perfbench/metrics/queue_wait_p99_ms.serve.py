"""99th percentile ms a request waited in the coalescing queue over the
window: ``RecommenderService.stats()['wait_p99_us']``."""


def read(ctx):
    s = ctx.counters.get("service")
    if not s or not s["completed"]:
        return None
    return s["wait_p99_us"] / 1e3

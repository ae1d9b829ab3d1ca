"""Host waits on the device a serving batch over the window: the
program's own counter, ``RecommenderService.stats()['host_waits']``
(each ``repro_torch.trace.host_wait`` its batches passed), over
its ``batches``.  Nothing to read where the program does not count
them."""


def read(ctx):
    s = ctx.counters.get("service")
    if not s or "host_waits" not in s or not s["batches"]:
        return None
    return s["host_waits"] / s["batches"]

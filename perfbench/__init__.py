"""The port's benchmark: one cell of ``BENCHMARK.json`` per run of ``run.py``.

Everything that decides a result lives here and nowhere in the program:
the seeded graph generator (``data``), the plain reference that decides
``correct`` (``reference``), the work counts (``rooflines``), the readers
of the per-layer metrics (``metrics``), the configurations, traffic mixes
and limits as data files (``configs``, ``mixes``, ``limits``), and the
general runners that read them (``harness``).
"""

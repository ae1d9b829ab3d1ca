"""General runners of the benchmark: they read the cell's data files and
know nothing of any one configuration, mix or metric."""

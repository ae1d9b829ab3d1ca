"""An autouse fixture for the port's CPU tests (not a test file): one
intra-op thread for torch while each test runs.

The suite runs in several pytest-xdist workers on one machine, and torch's
CPU ops each use a pool of as many OpenMP threads as the machine has
cores, so the workers' pools contend for the cores and small ops wait on
one another (six of these files under ``-n 6`` on 8 cores: 772 s with the
default pools, 65 s with one thread each).  Import it into a test module:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

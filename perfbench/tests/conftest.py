"""The benchmark's CPU tests: ``python -m pytest perfbench/tests``.

Tests marked ``cuda`` need the card and skip without one (decided inside
the ``cuda_device`` fixture, never at import)."""
import pytest

from perfbench.tests import tiny  # noqa: F401  (puts src/ on the path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

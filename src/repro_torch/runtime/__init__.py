"""The fault-tolerant training loop."""
from repro_torch.runtime.loop import (LoopConfig, LoopReport,  # noqa: F401
                                      run_pipeline, run_training)

from repro_torch.checkpoint.checkpoint import (latest_step,  # noqa: F401
                                               restore_checkpoint,
                                               save_checkpoint)

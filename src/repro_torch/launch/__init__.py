"""Launchers: ``python -m repro_torch.launch.train``."""

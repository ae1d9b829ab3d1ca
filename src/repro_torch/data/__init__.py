"""Synthetic interaction data (numpy, seeded)."""

"""Synthetic interaction data (numpy, seeded), the training loader and
k-hop neighbour sampling."""

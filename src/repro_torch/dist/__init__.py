"""Training beyond one full-graph step: the DistDGL-style subgraph
training baseline (``subgraph``) that the paper compares single-machine
full-graph training against."""

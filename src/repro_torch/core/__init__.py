"""Model pieces: LightGCN and NGCF init, BPR loss and sampling, the
large-batch schedule."""

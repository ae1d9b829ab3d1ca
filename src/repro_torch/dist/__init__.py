"""Distributed-training utilities.

  hints      — ambient sharding hints (the dp axis name and the process
               group) installed around each step of a sharded run;
  ring_spmm  — node-sharded SpMM over a ring of ranks (one ``spmm_csr``
               per ring step, the next block arriving meanwhile);
  subgraph   — the DistDGL-style subgraph-training baseline the paper
               compares single-machine full-graph training against.
"""

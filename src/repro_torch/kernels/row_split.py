"""Merge-path partition of a CSR row reduction into equal chunks.

The host half of ``csrc/row_split.cuh``.  Rows and edges form one merge
sequence of ``n_nodes + n_edges`` items (row v's edges, then an end
marker for row v); it is cut into chunks of ``chunk`` items, so no chunk
holds more than ``chunk`` edges whatever the degree of its rows.  For
each chunk boundary c·chunk the table holds the number of row markers
before it: the first row chunk c touches.  It is computed on the device
with one ``torch.searchsorted`` and no host read; the chunk count comes
from the shapes alone.

``n_edges`` is taken from the shapes (the length of the edge arrays), so
it may exceed ``indptr[n_nodes]`` when ``indptr`` is longer than
``n_nodes + 1``: chunks past the last marker then touch no row.
"""
from __future__ import annotations

import torch


def n_chunks(n_nodes: int, n_edges: int, chunk: int) -> int:
    """Chunks of ``chunk`` merge items over ``n_nodes + n_edges`` items."""
    return -(-(n_nodes + n_edges) // chunk)


def chunk_rows(indptr: torch.Tensor, n_nodes: int, n_edges: int,
               chunk: int) -> torch.Tensor:
    """i64[n_chunks + 1]: entry c is the number of rows whose end marker
    (merge position ``indptr[v+1] + v``) lies before ``c * chunk``; the
    last entry is ``n_nodes``."""
    dev = indptr.device
    ends = indptr[1:n_nodes + 1].to(torch.int64) \
        + torch.arange(n_nodes, dtype=torch.int64, device=dev)
    starts = torch.arange(0, (n_chunks(n_nodes, n_edges, chunk) + 1) * chunk,
                          chunk, dtype=torch.int64, device=dev)
    return torch.searchsorted(ends, starts)

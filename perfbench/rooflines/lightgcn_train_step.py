"""Model FLOPs of one full-graph LightGCN BPR training step, nothing
recomputed.

Counts the arithmetic the model needs, not what an implementation does
again.  E is the number of train edges, D the embedding width, N = U + I
the nodes, B the BPR batch, L the layers:

  layer: the two neighbourhood sums (E·D adds each) and the degree
    scalings at both ends of both (2·N·D multiplies); the layer mean
    (L + 1)·N·D.  Every op is linear in one input, so its backward is one
    more pass of the same size: 2x the forward.
  BPR on the final width D: two dots and three squared norms of B rows
    (10·B·D), 3x with their backward.
  Adam: 12 operations per parameter element (N·D).

A training cell's whole-step count is ``rooflines/<arch>_train_step.py``,
found by the configuration's ``arch``.
"""


def flops(n_users: int, n_items: int, n_edges: int, dim: int,
          n_layers: int, batch: int) -> float:
    n = n_users + n_items
    linear = n_layers * (2.0 * n_edges * dim + 2.0 * n * dim) \
        + (n_layers + 1) * n * dim
    return 2.0 * linear + 3.0 * 10.0 * batch * dim + 12.0 * n * dim

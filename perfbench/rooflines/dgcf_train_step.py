"""Model FLOPs of one full-graph DGCF BPR training step, nothing
recomputed, counted as ``lightgcn_train_step.py`` counts them.

E is the number of train edges, D the embedding width, N = U + I the
nodes, B the BPR batch, L the layers; K intents and T routing iterations
a layer at the published values (the program's ``core/dgcf.py`` and the
reference's ``reference/dgcf.py``):

  routing iteration, both directions: the softmax over the intents
    (3·E·K each: exponent, sum, divide) and the degrees (E·K each); the
    inverse square roots (N·K); the pre- and post-scaling of the chunks
    (2·N·D); the two intent aggregations (2·E·D each).
  agreement (every iteration but the last of the last layer): normalising
    h (3·N·D), the two directions' per-intent dots (2·E·D each) and the
    logit updates (E·K each); once a layer, tanh of the normalised input
    (4·N·D).
  the layer mean (L + 1)·N·D.  Every op is linear or bilinear in its
    inputs or elementwise: its backward is two passes of its size, so 3x
    the forward.
  BPR on the final width D: two dots and three squared norms of B rows
    (10·B·D), 3x with their backward.
  Adam: 12 operations per parameter element (N·D).
"""
N_FACTORS = 4
N_ITERATIONS = 2


def flops(n_users: int, n_items: int, n_edges: int, dim: int,
          n_layers: int, batch: int) -> float:
    n = n_users + n_items
    e, k = float(n_edges), N_FACTORS
    route = 2.0 * (4.0 * e * k + 2.0 * e * dim) + n * k + 2.0 * n * dim
    agree = 2.0 * (2.0 * e * dim + e * k) + 3.0 * n * dim
    agreements = n_layers * N_ITERATIONS - 1 if n_layers else 0
    forward = n_layers * (N_ITERATIONS * route + 4.0 * n * dim) \
        + agreements * agree + (n_layers + 1) * n * dim
    return 3.0 * forward + 3.0 * 10.0 * batch * dim + 12.0 * n * dim

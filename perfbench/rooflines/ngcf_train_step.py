"""Model FLOPs of one full-graph NGCF BPR training step, nothing
recomputed (a backward that recomputes edge products counts once).

E is the number of train edges, D the embedding width, N = U + I the
nodes, B the BPR batch, L the layers:

  layer: the two sums (2·E·D), the LeakyReLU and the sum of the two
    products (2·N·D): 2x with the backward; the Hadamard products with
    the sums (N·D) and the four [n, D] @ [D, D] products (4·2·N·D²) need
    a gradient for each of their two inputs: 3x.
  BPR on the concatenated width (L + 1)·D: two dots and three squared
    norms of B rows, 3x with their backward.
  Adam: 12 operations per parameter element (N·D + 2·L·D²).
"""


def flops(n_users: int, n_items: int, n_edges: int, dim: int,
          n_layers: int, batch: int) -> float:
    n = n_users + n_items
    linear = n_layers * (2.0 * n_edges * dim + 2.0 * n * dim)
    products = n_layers * (n * dim + 8.0 * n * dim * dim)
    out = (n_layers + 1) * dim
    params = n * dim + 2 * n_layers * dim * dim
    return 2.0 * linear + 3.0 * products + 3.0 * 10.0 * batch * out \
        + 12.0 * params

"""Message-passing layer (paper Eq 1-3) with the §4 dataflow optimizations
as explicit rewrite levels (the port of ``repro/core/message_passing.py``).

opt_level:
  0  naive        — per-edge dense matmuls then scatter-add, the DGL-style
                    dataflow of Fig 4a: O(|E|) weight matmuls.
  1  +reorder     — Fig 4b: aggregate first, multiply weights at node
                    level: O(|V|) matmuls (optimization O1).
  2  +kernelize   — Fig 4c: messages from the SDDMM kernel (O2): two
                    ``sddmm('mul')`` launches per layer.
  3  +sddmm reuse — x_u⊙x_i computed once per layer and reused for both
                    directions (O3): one launch per layer.

Levels 1 and 2 share one branch, as in the reference, where the
"kernelize" step is the ``impl`` choice: levels 1-3 form their messages
with ``kernels.ops.sddmm`` routed by ``impl`` (None: the CUDA kernel for a
CUDA tensor), so level 1 without the kernel is level 1 with
``impl='torch'``.  Its backward recomputes the gathers, so no level keeps
an [E, D] message matrix for autograd except level 0.  Levels 1-3 are
equal; level 0 differs by float reassociation.  Each sddmm call gets the
graph's user groups (``BipartiteGraph.user_groups``, built once per
graph), so that the kernel walks the edges by user and reads each user
row about once.
"""
from __future__ import annotations

import torch

from repro_torch.core import sparse_ops
from repro_torch.core.graph import BipartiteGraph
from repro_torch.kernels import ops as kops


def ngcf_propagate_bipartite(g: BipartiteGraph, x_user, x_item, w1, w2,
                             opt_level: int = 3, impl: str | None = None):
    """One NGCF message-passing layer on the bipartite graph; returns
    (h_user, h_item).

    m_e = (x_src ⊙ x_dst) W1 + x_src W2 ;  h_dst = Σ_e m_e
    """
    u, i, mask = g.user, g.item, g.edge_mask
    nu, ni = g.n_users, g.n_items
    m2 = mask[:, None]

    if opt_level == 0:
        # Fig 4a: weight matmuls at edge level (O(|E|) dense FLOPs), written
        # as the reference writes it: mul_ui @ w1 once per direction
        mul_ui = torch.where(m2, x_user.index_select(0, u)
                             * x_item.index_select(0, i), 0.0)
        m_to_item = mul_ui @ w1 \
            + torch.where(m2, x_user.index_select(0, u), 0.0) @ w2
        m_to_user = mul_ui @ w1 \
            + torch.where(m2, x_item.index_select(0, i), 0.0) @ w2
        h_item = sparse_ops.segment_sum(m_to_item, i, ni)
        h_user = sparse_ops.segment_sum(m_to_user, u, nu)
        return h_user, h_item

    groups = g.user_groups()     # keys u: src below, dst in O2's second call
    if opt_level >= 3:
        # O3: one SDDMM serves both directions (x_u⊙x_i == x_i⊙x_u)
        mul_e = kops.sddmm("mul", x_user, x_item, u, i, mask, impl=impl,
                           groups=groups)
        agg_mul_item = sparse_ops.spmm("sum", mul_e, i, ni, mask)
        agg_mul_user = sparse_ops.spmm("sum", mul_e, u, nu, mask)
    else:
        mul_e_item = kops.sddmm("mul", x_user, x_item, u, i, mask, impl=impl,
                                groups=groups)
        mul_e_user = kops.sddmm("mul", x_item, x_user, i, u, mask, impl=impl,
                                groups=groups)
        agg_mul_item = sparse_ops.spmm("sum", mul_e_item, i, ni, mask)
        agg_mul_user = sparse_ops.spmm("sum", mul_e_user, u, nu, mask)

    # O1: aggregate raw src features first, then one node-level matmul
    agg_src_item = sparse_ops.gspmm_copy_sum(x_user, u, i, ni, mask)
    agg_src_user = sparse_ops.gspmm_copy_sum(x_item, i, u, nu, mask)
    h_item = agg_mul_item @ w1 + agg_src_item @ w2
    h_user = agg_mul_user @ w1 + agg_src_user @ w2
    return h_user, h_item


def lightgcn_propagate_bipartite(g: BipartiteGraph, x_user, x_item,
                                 coeff_ui=None):
    """One LightGCN layer: h_dst = Σ_e coeff_e · x_src (no weights)."""
    u, i, mask = g.user, g.item, g.edge_mask
    h_item = sparse_ops.gspmm_copy_sum(x_user, u, i, g.n_items, mask,
                                       coeff_ui)
    h_user = sparse_ops.gspmm_copy_sum(x_item, i, u, g.n_users, mask,
                                       coeff_ui)
    return h_user, h_item


def bipartite_sym_coeff(g: BipartiteGraph) -> torch.Tensor:
    """1/sqrt(d_u d_i) per interaction (LightGCN normalization)."""
    ones = g.edge_mask.to(torch.float32)
    du = ones.new_zeros(g.n_users).index_add_(0, g.user, ones).clamp_min(1.0)
    di = ones.new_zeros(g.n_items).index_add_(0, g.item, ones).clamp_min(1.0)
    c = torch.rsqrt(du.index_select(0, g.user)) \
        * torch.rsqrt(di.index_select(0, g.item))
    return torch.where(g.edge_mask, c, 0.0)

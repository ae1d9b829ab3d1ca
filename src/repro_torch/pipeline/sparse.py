"""Both CSR directions of a user-item graph and the kernel-routed
aggregations the models need (the port of ``repro/pipeline/sparse.py``'s
``BipartiteCSR``; the ring dispatch comes with ROADMAP A10).

The graph is sorted into the two CSR directions once on the host and
moved to ``device``; every aggregation is one ``kernels.ops`` call (the
CUDA kernel for tensors on the card, the plain version on the CPU).
LightGCN's normalisation 1/sqrt(d_u d_i) is separable, so the kernels run
unweighted and the degree scalings apply at node level.

Autodiff: each aggregation is a ``torch.autograd.Function`` whose
backward runs the same kernels again, as the reference's custom VJPs do:

  * adjacency matmul (gather SpMM):  d/dx (A x) = Aᵀ ct — the opposite
    direction's gather SpMM;
  * edge aggregation (no-gather SpMM): d/dvalues = ct[dst_e];
  * Hadamard aggregation: saves only the node embeddings (x, y) and
    recomputes the edge products in two more ``hadamard_spmm`` calls
    (the [E, D] message matrix exists neither forward nor backward).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.spmm import build_csr_by_dst

HADAMARD_ROUTES = ("auto", "fused", "composed")


class _AdjMatmul(torch.autograd.Function):
    """out = A x by gather SpMM over ``fwd`` = (indptr, src, n_dst);
    backward = Aᵀ ct over the reverse CSR ``bwd`` = (indptr, src, n_src)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, impl):
        ctx.bwd, ctx.impl = bwd, impl
        indptr, src, n = fwd
        return kops.spmm_csr("sum", x.contiguous(), indptr, src, n,
                             gather=True, impl=impl)

    @staticmethod
    def backward(ctx, ct):
        indptr, src, n = ctx.bwd
        return (kops.spmm_csr("sum", ct.contiguous(), indptr, src, n,
                              gather=True, impl=ctx.impl), None, None, None)


class _EdgeAgg(torch.autograd.Function):
    """out[v] = sum of the dst-sorted edge values into v; backward =
    ct[dst_e], the SDDMM-copy gather."""

    @staticmethod
    def forward(ctx, values, indptr, dst_sorted, n_dst, impl):
        ctx.dst = dst_sorted
        # the index operand is not read when gather=False
        return kops.spmm_csr("sum", values.contiguous(), indptr, dst_sorted,
                             n_dst, gather=False, impl=impl)

    @staticmethod
    def backward(ctx, ct):
        return ct[ctx.dst.long()], None, None, None, None


class _HadamardAgg(torch.autograd.Function):
    """out[v] = sum_{e: dst_e = v} x[src_e] * y[v] over ``fwd`` =
    (indptr, src, dst, n_dst), with a rematerialising backward over the
    reverse CSR ``bwd`` = (indptr, src, n_src):

      d_x[s] = sum_{e: src_e = s} ct[dst_e] * y[dst_e]  (x_eq_y, reverse CSR)
      d_y[v] = ct[v] * sum_{e: dst_e = v} x[src_e]      (y_is_dst, forward CSR)
    """

    @staticmethod
    def forward(ctx, x, y, fwd, bwd, impl):
        x, y = x.contiguous(), y.contiguous()
        ctx.save_for_backward(x, y)
        ctx.fwd, ctx.bwd, ctx.impl = fwd, bwd, impl
        indptr, src, dst, n = fwd
        return kops.hadamard_spmm(x, y, indptr, src, dst, n,
                                  structure="y_is_dst", impl=impl)

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        ct = ct.contiguous()
        d_x = d_y = None
        if ctx.needs_input_grad[0]:
            indptr, src, n = ctx.bwd
            d_x = kops.hadamard_spmm(ct, y, indptr, src, src, n,
                                     structure="x_eq_y", impl=ctx.impl)
        if ctx.needs_input_grad[1]:
            indptr, src, dst, n = ctx.fwd
            d_y = kops.hadamard_spmm(x, ct, indptr, src, dst, n,
                                     structure="y_is_dst", impl=ctx.impl)
        return d_x, d_y, None, None, None


class BipartiteCSR:
    """Both CSR directions of a user-item graph + kernel-routed ops.

      agg_u2i(x_user)  -> [n_items, D]   unweighted Aᵀx
      agg_i2u(x_item)  -> [n_users, D]   unweighted A x
      edge_agg_item(m) -> [n_items, D]   m in ui (item-sorted) edge order
      edge_agg_user(m) -> [n_users, D]   m in iu (user-sorted) edge order
      perm_ui_to_iu    reorders ui-order edge values into iu order
      hadamard_agg_item(xu, xi) -> [n_items, D]   sum_e xu[u_e] * xi[i]
      hadamard_agg_user(xi, xu) -> [n_users, D]   sum_e xi[i_e] * xu[u]
      sym_propagate(x_user, x_item) -> one normalised LightGCN layer

    ``hadamard`` selects NGCF's Hadamard-message route: 'fused' (the
    no-[E, D] ops), 'composed' (the edge_agg path) or 'auto' (fused:
    only the ring dispatch, which the port does not have yet, would pick
    composed); ``fused_hadamard`` is the resolved choice.
    """

    def __init__(self, user: np.ndarray, item: np.ndarray, n_users: int,
                 n_items: int, edge_mask: np.ndarray | None = None,
                 device="cuda", impl: str | None = None,
                 hadamard: str = "auto"):
        if impl == "ring":
            raise NotImplementedError(
                "impl='ring' (sharded ring SpMM) is ROADMAP A10, which the "
                "port does not have yet")
        if hadamard not in HADAMARD_ROUTES:
            raise ValueError(f"hadamard must be 'auto', 'fused' or "
                             f"'composed', got {hadamard!r}")
        dev = resolve_device(device)
        self.device = dev
        self.impl = impl
        self.fused_hadamard = hadamard != "composed"
        user = np.asarray(user, np.int32)
        item = np.asarray(item, np.int32)
        if edge_mask is not None:
            keep = np.asarray(edge_mask).astype(bool)
            user, item = user[keep], item[keep]
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self.n_edges = len(user)

        ui_indptr, ui_src, perm_ui = build_csr_by_dst(item, user, n_items)
        iu_indptr, iu_src, perm_iu = build_csr_by_dst(user, item, n_users)
        # host copies of the user-CSR: the eval/serving seen-item set
        self._seen_indptr = np.asarray(iu_indptr, np.int64)
        self._seen_items = np.asarray(iu_src, np.int64)
        inv_ui = np.empty(self.n_edges, np.int64)
        inv_ui[perm_ui] = np.arange(self.n_edges)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        # int64 row pointers: edge counts may pass 2^31
        self.ui_indptr = put(ui_indptr, torch.int64)
        self.ui_src = put(ui_src, torch.int32)            # user per edge
        self.ui_dst = put(item[perm_ui], torch.int32)     # item per edge
        self.iu_indptr = put(iu_indptr, torch.int64)
        self.iu_src = put(iu_src, torch.int32)            # item per edge
        self.iu_dst = put(user[perm_iu], torch.int32)     # user per edge
        self.perm_ui_to_iu = put(inv_ui[perm_iu], torch.int32)
        du = np.bincount(user, minlength=n_users).astype(np.float32)
        di = np.bincount(item, minlength=n_items).astype(np.float32)
        self.rsqrt_du = put(1.0 / np.sqrt(np.maximum(du, 1.0)), torch.float32)
        self.rsqrt_di = put(1.0 / np.sqrt(np.maximum(di, 1.0)), torch.float32)
        self._ui = (self.ui_indptr, self.ui_src, self.n_items)
        self._iu = (self.iu_indptr, self.iu_src, self.n_users)

    def agg_u2i(self, x_user: torch.Tensor) -> torch.Tensor:
        return _AdjMatmul.apply(x_user, self._ui, self._iu, self.impl)

    def agg_i2u(self, x_item: torch.Tensor) -> torch.Tensor:
        return _AdjMatmul.apply(x_item, self._iu, self._ui, self.impl)

    def edge_agg_item(self, m: torch.Tensor) -> torch.Tensor:
        return _EdgeAgg.apply(m, self.ui_indptr, self.ui_dst, self.n_items,
                              self.impl)

    def edge_agg_user(self, m: torch.Tensor) -> torch.Tensor:
        return _EdgeAgg.apply(m, self.iu_indptr, self.iu_dst, self.n_users,
                              self.impl)

    def hadamard_agg_item(self, xu: torch.Tensor,
                          xi: torch.Tensor) -> torch.Tensor:
        return _HadamardAgg.apply(
            xu, xi, (self.ui_indptr, self.ui_src, self.ui_dst, self.n_items),
            self._iu, self.impl)

    def hadamard_agg_user(self, xi: torch.Tensor,
                          xu: torch.Tensor) -> torch.Tensor:
        return _HadamardAgg.apply(
            xi, xu, (self.iu_indptr, self.iu_src, self.iu_dst, self.n_users),
            self._ui, self.impl)

    def seen_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, items) numpy user-CSR over the train interactions:
        items[indptr[u]:indptr[u+1]] are user u's already-seen item ids."""
        return self._seen_indptr, self._seen_items

    def csr_nbytes(self) -> int:
        """Bytes of the CSR adjacency (both directions) as the reference
        counts them: its seven arrays at its dtypes, all int32, so the
        planner's profiles and ``describe()`` lines equal the reference's.
        The port holds its two row-pointer arrays as int64, so it holds
        ``port_csr_nbytes()`` — (n_users + n_items + 2) × 4 B more."""
        return 4 * (5 * self.n_edges + self.n_users + self.n_items + 2)

    def port_csr_nbytes(self) -> int:
        """Bytes of the seven CSR arrays as the port holds them."""
        arrs = (self.ui_indptr, self.ui_src, self.ui_dst, self.iu_indptr,
                self.iu_src, self.iu_dst, self.perm_ui_to_iu)
        return sum(a.numel() * a.element_size() for a in arrs)

    def ring_nbytes(self) -> int:
        """Bytes of the ring bucket cubes: 0, the port has no ring
        dispatch (ROADMAP A10)."""
        return 0

    def graph_nbytes(self) -> int:
        """Bytes of the whole adjacency structure (CSR + ring cubes)."""
        return self.csr_nbytes() + self.ring_nbytes()

    def sym_propagate(self, x_user: torch.Tensor, x_item: torch.Tensor):
        """One symmetric-normalised propagation (a LightGCN/GCN layer):
        h_i = sum_e x_u / sqrt(d_u d_i), both directions."""
        h_item = self.agg_u2i(x_user * self.rsqrt_du[:, None]) \
            * self.rsqrt_di[:, None]
        h_user = self.agg_i2u(x_item * self.rsqrt_di[:, None]) \
            * self.rsqrt_du[:, None]
        return h_user, h_item

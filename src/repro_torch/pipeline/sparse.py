"""Both CSR directions of a user-item graph and the kernel-routed
aggregations LightGCN needs (the port of ``repro/pipeline/sparse.py``'s
``BipartiteCSR``; the ring dispatch and the Hadamard routes come with
later slices).

The graph is sorted into the two CSR directions once on the host and
moved to ``device``; every aggregation is one ``kernels.ops.spmm_csr``
call (the CUDA kernel for tensors on the card, the plain version on the
CPU).  LightGCN's normalisation 1/sqrt(d_u d_i) is separable, so the
kernels run unweighted and the degree scalings apply at node level.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.spmm import build_csr_by_dst


class BipartiteCSR:
    """agg_u2i(x_user) -> [n_items, D] (unweighted Aᵀx);
    agg_i2u(x_item) -> [n_users, D] (unweighted A x);
    sym_propagate(x_user, x_item) -> one normalised LightGCN layer."""

    def __init__(self, user: np.ndarray, item: np.ndarray, n_users: int,
                 n_items: int, edge_mask: np.ndarray | None = None,
                 device="cuda", impl: str | None = None):
        dev = resolve_device(device)
        self.device = dev
        self.impl = impl
        user = np.asarray(user, np.int32)
        item = np.asarray(item, np.int32)
        if edge_mask is not None:
            keep = np.asarray(edge_mask).astype(bool)
            user, item = user[keep], item[keep]
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self.n_edges = len(user)

        ui_indptr, ui_src, _ = build_csr_by_dst(item, user, n_items)
        iu_indptr, iu_src, _ = build_csr_by_dst(user, item, n_users)
        # host copies of the user-CSR: the eval/serving seen-item set
        self._seen_indptr = np.asarray(iu_indptr, np.int64)
        self._seen_items = np.asarray(iu_src, np.int64)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        # int64 row pointers: edge counts may pass 2^31
        self.ui_indptr = put(ui_indptr, torch.int64)
        self.ui_src = put(ui_src, torch.int32)            # user per edge
        self.iu_indptr = put(iu_indptr, torch.int64)
        self.iu_src = put(iu_src, torch.int32)            # item per edge
        du = np.bincount(user, minlength=n_users).astype(np.float32)
        di = np.bincount(item, minlength=n_items).astype(np.float32)
        self.rsqrt_du = put(1.0 / np.sqrt(np.maximum(du, 1.0)), torch.float32)
        self.rsqrt_di = put(1.0 / np.sqrt(np.maximum(di, 1.0)), torch.float32)

    def agg_u2i(self, x_user: torch.Tensor) -> torch.Tensor:
        return kops.spmm_csr("sum", x_user, self.ui_indptr, self.ui_src,
                             self.n_items, gather=True, impl=self.impl)

    def agg_i2u(self, x_item: torch.Tensor) -> torch.Tensor:
        return kops.spmm_csr("sum", x_item, self.iu_indptr, self.iu_src,
                             self.n_users, gather=True, impl=self.impl)

    def seen_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, items) numpy user-CSR over the train interactions:
        items[indptr[u]:indptr[u+1]] are user u's already-seen item ids."""
        return self._seen_indptr, self._seen_items

    def sym_propagate(self, x_user: torch.Tensor, x_item: torch.Tensor):
        """One symmetric-normalised propagation (a LightGCN layer):
        h_i = sum_e x_u / sqrt(d_u d_i), both directions."""
        h_item = self.agg_u2i((x_user * self.rsqrt_du[:, None]).contiguous()) \
            * self.rsqrt_di[:, None]
        h_user = self.agg_i2u((x_item * self.rsqrt_di[:, None]).contiguous()) \
            * self.rsqrt_du[:, None]
        return h_user, h_item

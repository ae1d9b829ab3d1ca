"""Both CSR directions of a user-item graph and the kernel-routed
aggregations the models need (the port of ``repro/pipeline/sparse.py``'s
``BipartiteCSR`` and its ring dispatch).

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
    (the [E, D] message matrix exists neither forward nor backward);
  * intent aggregation (DGCF, ``intent_spmm``: out = A_w x with one
    weight per edge and intent): d/dx = A_wᵀ ct, the same kernel over the
    reverse CSR with the weights permuted into its edge order, and d/dw =
    the per-edge, per-intent dots of ct and x (``intent_sddmm``);
  * intent agreement (``intent_sddmm``: s_e = <a[row_e], b[src_e]> per
    intent): d/da = A_g b and d/db = A_gᵀ a, ``intent_spmm`` over the
    forward and the reverse CSR.  Per-edge state is [E, K], never [E, D].

Sharded dispatch: under a ``ShardPlan`` that ``wants_ring``, node
aggregation runs through ``dist.ring_spmm`` over the *unified* node space
(users then items, padded to a multiple of the shard count).  The
symmetric propagation is one ring per layer (both directions at once), and
every ring op's backward is the transpose ring.  The models pass full
(replicated) tables; each op slices this rank's block out of them, runs
the ring and all-gathers the blocks again (``dist.collectives.gather_rows``,
whose backward reduce-scatters), so the registry's forwards run
unchanged.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.ring_spmm import RingSpmm, bucket_counts, cube_nbytes
from repro_torch.kernels import ops as kops
from repro_torch.kernels.spmm import build_csr_by_dst
from repro_torch.dist.collectives import gather_rows, rank_of
from repro_torch.pipeline.shard import ShardPlan
from repro_torch import trace

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


class _IntentAgg(torch.autograd.Function):
    """out[v, chunk k] = sum_{e in row v} w[e, k] * x[src_e, chunk k] over
    ``fwd`` = (indptr, src, n_dst), w in ``fwd``'s edge order; backward
    over the reverse CSR ``bwd`` = (indptr, src, n_src), ``to_bwd`` taking
    [E, K] edge values from ``fwd``'s order into ``bwd``'s:

      d_w[e, k] = <ct[row_e, chunk k], x[src_e, chunk k]>  (intent_sddmm, fwd)
      d_x = the same aggregation of ct with to_bwd(w)      (intent_spmm, bwd)
    """

    @staticmethod
    def forward(ctx, w, x, fwd, bwd, to_bwd, impl):
        w, x = w.contiguous(), x.contiguous()
        ctx.save_for_backward(w, x)
        ctx.fwd, ctx.bwd, ctx.to_bwd, ctx.impl = fwd, bwd, to_bwd, impl
        indptr, src, n = fwd
        return kops.intent_spmm(w, x, indptr, src, n, impl=impl)

    @staticmethod
    def backward(ctx, ct):
        w, x = ctx.saved_tensors
        ct = ct.contiguous()
        d_w = d_x = None
        if ctx.needs_input_grad[0]:
            indptr, src, _ = ctx.fwd
            d_w = kops.intent_sddmm(ct, x, indptr, src, w.shape[1],
                                    impl=ctx.impl)
        if ctx.needs_input_grad[1]:
            indptr, src, n = ctx.bwd
            d_x = kops.intent_spmm(ctx.to_bwd(w), ct, indptr, src, n,
                                   impl=ctx.impl)
        return d_w, d_x, None, None, None, None


class _IntentAgree(torch.autograd.Function):
    """s[e, k] = <a[row_e, chunk k], b[src_e, chunk k]> over ``fwd`` =
    (indptr, src, n_rows), in its edge order; backward:

      d_a = sum_{e in row} g[e, k] * b[src_e, chunk k]   (intent_spmm, fwd)
      d_b = the same over the reverse CSR ``bwd`` with to_bwd(g) and a
    """

    @staticmethod
    def forward(ctx, a, b, n_factors, fwd, bwd, to_bwd, impl):
        a, b = a.contiguous(), b.contiguous()
        ctx.save_for_backward(a, b)
        ctx.fwd, ctx.bwd, ctx.to_bwd, ctx.impl = fwd, bwd, to_bwd, impl
        indptr, src, _ = fwd
        return kops.intent_sddmm(a, b, indptr, src, n_factors, impl=impl)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        d_a = d_b = None
        if ctx.needs_input_grad[0]:
            indptr, src, n = ctx.fwd
            d_a = kops.intent_spmm(g, b, indptr, src, n, impl=ctx.impl)
        if ctx.needs_input_grad[1]:
            indptr, src, n = ctx.bwd
            d_b = kops.intent_spmm(ctx.to_bwd(g), a, indptr, src, n,
                                   impl=ctx.impl)
        return d_a, d_b, None, None, None, None, None


# one element as wide as a row of 4, 8 or 16 bytes (its bits copied as
# they are)
_ROW_AS_ONE = {4: torch.int32, 8: torch.int64, 16: torch.complex128}


def take_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] (int64 idx) for narrow rows: DGCF's [E, K] edge values and
    [N, K] node values.  A row of 4, 8 or 16 bytes is viewed as one
    element and taken by ``torch.take``, one thread an index: on the card
    ``index_select``, ``gather`` and indexing give each index a thread
    block of its own, and 16-byte rows leave nearly all of its threads
    idle (9.1 ms for 15,083,885 rows of [E, 4] float32 on an H100)."""
    one = _ROW_AS_ONE.get(v.shape[1] * v.element_size())
    if one is None or not v.is_contiguous():
        return v[idx]
    return v.view(one).view(-1).take(idx).view(v.dtype).view(-1, v.shape[1])


class _RingOp(torch.autograd.Function):
    """out = ring ``fwd`` of this rank's block; backward = ring ``bwd``
    (the exact transpose) of the cotangent's block."""

    @staticmethod
    def forward(ctx, x, graph, fwd, bwd):
        ctx.graph, ctx.bwd = graph, bwd
        return graph.ring(fwd)(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.graph.ring(ctx.bwd)(ct.contiguous()), None, None, None


class _RingGraph:
    """Ring SpMMs over the unified node space of one bipartite graph (user
    u -> row u, item i -> row n_users + i, rows padded to a multiple of the
    shard count; padded rows own no edges).

    ``sym`` applies the symmetric adjacency (both edge directions in one
    ring pass); ``ui``/``iu`` only the user->item / item->user direction.
    Each ring is built on first use (LightGCN/GCN only ever build ``sym``).
    ``*_T`` keys are the exact transposes: the band keeps edge (s, d) by
    the ring distance of s's owner ahead of d's, an asymmetric criterion,
    so a banded transpose buckets the reversed *kept* edges over the full
    ring; unbanded, transposes alias the plain rings (``sym`` is
    self-adjoint, ``ui``/``iu`` are mutual transposes)."""

    def __init__(self, shard: ShardPlan, user: np.ndarray, item: np.ndarray,
                 n_users: int, n_items: int, device, impl):
        self.shard = shard
        self.device = device
        self.impl = impl
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self.part = shard.partition(n_users + n_items)
        self._src_ui = torch.from_numpy(np.asarray(user, np.int64)).to(device)
        self._dst_ui = torch.from_numpy(
            np.asarray(item, np.int64) + self.n_users).to(device)
        self._rings: dict[str, RingSpmm] = {}
        self._est = None

    @functools.cached_property
    def group(self):
        """The shard plan's process group, opened on first use: a graph
        builds (and sizes its buckets for the planner) without one."""
        return self.shard.process_group(self.device)

    @property
    def rank(self) -> int:
        return rank_of(self.group)

    def _banded(self) -> bool:
        s = self.shard.ring_steps
        return s is not None and s < self.shard.n_shards

    def _steps(self) -> int:
        s = self.shard.ring_steps
        return self.shard.n_shards if s is None else s

    def _sym_edges(self):
        s, d = self._src_ui, self._dst_ui
        return torch.cat([s, d]), torch.cat([d, s])

    def _build(self, src, dst, n_steps) -> RingSpmm:
        return RingSpmm(src, dst, self.part.n_local, self.shard.n_shards,
                        self.rank, self.group, n_steps=n_steps,
                        quantize=self.shard.ring_quant, impl=self.impl)

    def _band_kept(self, src, dst):
        """The subset of edges the banded forward actually applies."""
        n_local = self.part.n_local
        rel = torch.remainder(src // n_local - dst // n_local,
                              self.shard.n_shards)
        keep = rel < self.shard.ring_steps
        return src[keep], dst[keep]

    def ring(self, which: str) -> RingSpmm:
        """The memoized ring of ``which`` (sym, ui, iu or their ``*_T``)."""
        if which not in self._rings:
            s, d = self._src_ui, self._dst_ui
            steps = self.shard.ring_steps
            if which == "sym":
                self._rings[which] = self._build(*self._sym_edges(), steps)
            elif which == "ui":
                self._rings[which] = self._build(s, d, steps)
            elif which == "iu":
                self._rings[which] = self._build(d, s, steps)
            elif not self._banded():
                alias = {"sym_T": "sym", "ui_T": "iu", "iu_T": "ui"}
                self._rings[which] = self.ring(alias[which])
            else:
                base = {"sym_T": self._sym_edges(), "ui_T": (s, d),
                        "iu_T": (d, s)}[which]
                ks, kd = self._band_kept(*base)
                self._rings[which] = self._build(kd, ks, None)
        return self._rings[which]

    def _built(self) -> list[RingSpmm]:
        """The distinct rings built so far (aliases counted once)."""
        return list({id(r): r for r in self._rings.values()}.values())

    def est_nbytes(self) -> int:
        """Bytes the reference's sym bucket cubes occupy, from the bucket
        counts alone (the reference's formula: the planner profiles the
        graph before any ring is built)."""
        if self._est is None:
            self._est = cube_nbytes(bucket_counts(
                *self._sym_edges(), self.part.n_local, self.shard.n_shards,
                self._steps()))
        return self._est

    def nbytes(self) -> int:
        """Bucket bytes as the reference counts them: its cubes of the rings
        built so far, or the sym estimate before any is."""
        return max(sum(r.ref_nbytes for r in self._built()),
                   self.est_nbytes())

    def port_nbytes(self) -> int:
        """Bytes this rank holds for the rings built so far."""
        return sum(r.nbytes() for r in self._built())

    def apply(self, which: str, x: torch.Tensor, offset: int) -> torch.Tensor:
        """Ring ``which`` (backward: ``which``_T) over ``x``, rows [offset,
        offset + len(x)) of the unified space, every other row zero ->
        all unified rows [n_nodes, D] on every rank."""
        blk = self.part.block(x, self.rank, offset)
        h = _RingOp.apply(blk, self, which, which + "_T")
        return self.part.trim(gather_rows(h, self.group))


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
      intent_agg_user(w, x_item)  -> [n_users, D]  sum_e w[e, k] x_i chunk k
      intent_agg_item(w, x_user)  -> [n_items, D]  (w in iu / ui order)
      intent_agree_user(a_user, b_item, K) -> [E, K] iu order
      intent_agree_item(a_item, b_user, K) -> [E, K] ui order
      iu_to_ui(v) / ui_to_iu(v)   [E, K] edge values between the orders
      rows_to_edges(v, side)      [E, K] node values at each edge's row

    ``hadamard`` selects NGCF's Hadamard-message route: 'fused' (the
    no-[E, D] ops), 'composed' (the edge_agg path) or 'auto' — fused
    everywhere except under the ring dispatch, whose rotation schedule
    has no fused gather-multiply-aggregate; ``fused_hadamard`` is the
    resolved choice.

    ``shard`` (a ``ShardPlan`` that ``wants_ring``) or ``impl='ring'`` (a
    one-shard ring when no plan is given) routes ``agg_u2i``, ``agg_i2u``
    and ``sym_propagate`` through the ring; the CSR itself stays whole on
    every rank (the edge aggregations and the evaluation read it).
    """

    def __init__(self, user: np.ndarray, item: np.ndarray, n_users: int,
                 n_items: int, edge_mask: np.ndarray | None = None,
                 device="cuda", impl: str | None = None,
                 hadamard: str = "auto", shard: ShardPlan | None = None):
        if hadamard not in HADAMARD_ROUTES:
            raise ValueError(f"hadamard must be 'auto', 'fused' or "
                             f"'composed', got {hadamard!r}")
        if impl == "ring" and shard is None:
            shard = ShardPlan(spmm="ring")
        dev = resolve_device(device)
        self.device = dev
        # 'ring' picks the aggregation route; the kernels route by device
        self.impl = None if impl == "ring" else impl
        self.shard = shard
        self.spmm = "ring" if shard is not None and shard.wants_ring \
            else self.impl
        self.fused_hadamard = hadamard != "composed" and self.spmm != "ring"
        user = np.asarray(user, np.int32)
        item = np.asarray(item, np.int32)
        if edge_mask is not None:
            keep = np.asarray(edge_mask).astype(bool)
            user, item = user[keep], item[keep]
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self.n_edges = len(user)

        with trace.span("setup::csr"):
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
        self._ring = None
        if self.spmm == "ring":
            self._ring = _RingGraph(shard, user, item, n_users, n_items, dev,
                                    self.impl)

    def agg_u2i(self, x_user: torch.Tensor) -> torch.Tensor:
        if self._ring is not None:
            return self._ring.apply("ui", x_user, 0)[self.n_users:]
        return _AdjMatmul.apply(x_user, self._ui, self._iu, self.impl)

    def agg_i2u(self, x_item: torch.Tensor) -> torch.Tensor:
        if self._ring is not None:
            return self._ring.apply("iu", x_item, self.n_users)[:self.n_users]
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

    # int64 edge indices of DGCF's [E, K] gathers (``take_rows``), made on
    # first use and kept
    @functools.cached_property
    def _ui_to_iu_long(self) -> torch.Tensor:
        return self.perm_ui_to_iu.long()

    @functools.cached_property
    def _iu_to_ui_long(self) -> torch.Tensor:
        inv = torch.empty_like(self._ui_to_iu_long)
        inv[self._ui_to_iu_long] = torch.arange(self.n_edges,
                                                device=inv.device)
        return inv

    @functools.cached_property
    def _edge_rows_long(self) -> dict[str, torch.Tensor]:
        return {"user": self.iu_dst.long(), "item": self.ui_dst.long()}

    def rows_to_edges(self, v: torch.Tensor, side: str) -> torch.Tensor:
        """Each edge's row of the node values ``v``: ``v[u_e]`` in iu order
        for ``side`` 'user', ``v[i_e]`` in ui order for 'item'."""
        return take_rows(v, self._edge_rows_long[side])

    def ui_to_iu(self, v: torch.Tensor) -> torch.Tensor:
        """Edge values (rows of ``v``) from ui (item-sorted) order into iu
        (user-sorted) order."""
        return take_rows(v, self._ui_to_iu_long)

    def iu_to_ui(self, v: torch.Tensor) -> torch.Tensor:
        """Edge values from iu order into ui order."""
        return take_rows(v, self._iu_to_ui_long)

    def intent_agg_user(self, w: torch.Tensor,
                        x_item: torch.Tensor) -> torch.Tensor:
        """sum over u's edges of w[e, k] * x_item[i_e, chunk k]; w [E, K]
        in iu order."""
        return _IntentAgg.apply(w, x_item, self._iu, self._ui, self.iu_to_ui,
                                self.impl)

    def intent_agg_item(self, w: torch.Tensor,
                        x_user: torch.Tensor) -> torch.Tensor:
        """sum over i's edges of w[e, k] * x_user[u_e, chunk k]; w [E, K]
        in ui order."""
        return _IntentAgg.apply(w, x_user, self._ui, self._iu, self.ui_to_iu,
                                self.impl)

    def intent_agree_user(self, a_user: torch.Tensor, b_item: torch.Tensor,
                          n_factors: int) -> torch.Tensor:
        """[E, K] in iu order: <a_user[u_e, chunk k], b_item[i_e, chunk k]>."""
        return _IntentAgree.apply(a_user, b_item, n_factors, self._iu,
                                  self._ui, self.iu_to_ui, self.impl)

    def intent_agree_item(self, a_item: torch.Tensor, b_user: torch.Tensor,
                          n_factors: int) -> torch.Tensor:
        """[E, K] in ui order: <a_item[i_e, chunk k], b_user[u_e, chunk k]>."""
        return _IntentAgree.apply(a_item, b_user, n_factors, self._ui,
                                  self._iu, self.ui_to_iu, self.impl)

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
        """Bytes of the ring buckets as the reference counts them (its
        padded cubes over all shards, built or estimated), so plans agree;
        0 off the ring dispatch.  Each shard holds 1/P of them."""
        return self._ring.nbytes() if self._ring is not None else 0

    def port_ring_nbytes(self) -> int:
        """Bytes this rank holds for its ring buckets (one CSR per ring
        step: int64 row pointers, int32 sources)."""
        return self._ring.port_nbytes() if self._ring is not None else 0

    def graph_nbytes(self) -> int:
        """Bytes of the whole adjacency structure (CSR + ring cubes)."""
        return self.csr_nbytes() + self.ring_nbytes()

    def sym_propagate(self, x_user: torch.Tensor, x_item: torch.Tensor):
        """One symmetric-normalised propagation (a LightGCN/GCN layer):
        h_i = sum_e x_u / sqrt(d_u d_i), both directions; under the ring,
        one ring SpMM over the unified (symmetric) adjacency."""
        if self._ring is not None:
            z = torch.cat([x_user * self.rsqrt_du[:, None],
                           x_item * self.rsqrt_di[:, None]])
            h = self._ring.apply("sym", z, 0)
            return (h[:self.n_users] * self.rsqrt_du[:, None],
                    h[self.n_users:] * self.rsqrt_di[:, None])
        h_item = self.agg_u2i(x_user * self.rsqrt_du[:, None]) \
            * self.rsqrt_di[:, None]
        h_user = self.agg_i2u(x_item * self.rsqrt_di[:, None]) \
            * self.rsqrt_du[:, None]
        return h_user, h_item

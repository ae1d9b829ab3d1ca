"""Ring SpMM — node-sharded sparse aggregation over a ring of ranks (the
port of ``repro/dist/ring_spmm.py``).

The feature matrix is row-sharded over the P ranks; edges are bucketed by
(destination rank, ring distance to the source rank).  At ring step k
every rank holds the feature block of rank (r + k) mod P and aggregates
exactly the bucket whose sources live there; the block for step k + 1
arrives (``dist.batch_isend_irecv``: send to (r − 1) mod P, receive from
(r + 1) mod P) while bucket k is aggregated — the paper's NUMA-blocked
Fig 11 schedule as a ring.  The [n_local, D] output block never leaves
its rank.

Each ring step is one ``kernels.ops.spmm_csr`` call (sum, gather=True)
over that bucket's CSR keyed by local dst, built once per graph: the CUDA
kernel on the card, its plain segment sum on the CPU.  The buckets are
unweighted (the degree scalings apply at node level in
``pipeline.sparse``), so the reference's masked [E_b, D] message matrix
is never formed.

``n_steps < P`` gives a banded ring: only the n_steps nearest source owners
are visited and edges outside the band are dropped.  ``quantize=True``
rotates an int8 payload (the reference's: symmetric per-block, scale =
max|x| / 127 + 1e-12, round half to even, clipped to ±127) and
dequantizes it before the kernel; bucket 0 reads the exact local block.
The reference rotates ``steps`` times and discards the last rotation; the
ring here rotates ``steps − 1`` times a call and counts its rotations and
payload bytes.

``bucket_edges`` and ``_bucket_edges_loop`` are the reference's host
layout of all P ranks' buckets (padded cubes), kept bit for bit; the ring
builds its own rank's buckets with torch on the graph's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops
from repro_torch.optim.compression import quantize_rows_int8_tensor


def bucket_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int, p: int,
                 coeff: np.ndarray | None = None, n_steps: int | None = None,
                 pad_multiple: int = 8):
    """Bucket edges by (dst device, relative ring step).

    Nodes are block-partitioned: device d owns rows [d*n_local,
    (d+1)*n_local).  Bucket [d, k] holds the edges whose dst lives on d
    and whose src lives on (d+k) mod p, with *local* row indices, padded
    to a uniform size; within a bucket edges keep their original order.

    Returns (src_l, dst_l, mask, n_local) — each array [p, n_steps, E_b]
    — or (src_l, dst_l, mask, coeff_l, n_local) when ``coeff`` is given.
    """
    if n_nodes % p:
        raise ValueError(f"n_nodes {n_nodes} not divisible by {p} devices; "
                         "pad via pipeline.shard.NodePartition")
    n_local = n_nodes // p
    steps = p if n_steps is None else n_steps
    src = np.asarray(src)
    dst = np.asarray(dst)
    sdev = src // n_local
    ddev = dst // n_local
    rel = (sdev - ddev) % p
    keep = np.nonzero(rel < steps)[0]          # banded ring drops the rest
    d_k = ddev[keep]
    k_k = rel[keep]
    order = np.lexsort((k_k, d_k))             # stable: (d, k), orig order
    sel = keep[order]
    flat_bucket = d_k[order] * steps + k_k[order]
    counts = np.bincount(flat_bucket, minlength=p * steps)
    emax = max(int(counts.max()) if counts.size else 1, 1)
    emax = int(np.ceil(emax / pad_multiple)) * pad_multiple
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(sel)) - np.repeat(starts, counts)
    slot = flat_bucket * emax + within         # position in the padded cube
    shape = (p, steps, emax)
    src_l = np.zeros(shape, np.int32)
    dst_l = np.zeros(shape, np.int32)
    mask = np.zeros(shape, bool)
    src_l.reshape(-1)[slot] = src[sel] % n_local
    dst_l.reshape(-1)[slot] = dst[sel] % n_local
    mask.reshape(-1)[slot] = True
    if coeff is not None:
        coeff_l = np.zeros(shape, np.float32)
        coeff_l.reshape(-1)[slot] = np.asarray(coeff)[sel]
        return src_l, dst_l, mask, coeff_l, n_local
    return src_l, dst_l, mask, n_local


def _bucket_edges_loop(src, dst, n_nodes: int, p: int, coeff=None,
                       n_steps: int | None = None, pad_multiple: int = 8):
    """The O(P·steps) per-bucket selection loop, kept as the layout oracle
    for the vectorized ``bucket_edges``."""
    if n_nodes % p:
        raise ValueError(f"n_nodes {n_nodes} not divisible by {p} devices")
    n_local = n_nodes // p
    steps = p if n_steps is None else n_steps
    src = np.asarray(src)
    dst = np.asarray(dst)
    sdev = src // n_local
    ddev = dst // n_local
    rel = (sdev - ddev) % p
    keep = rel < steps
    buckets: dict[tuple[int, int], np.ndarray] = {}
    emax = 1
    for d in range(p):
        for k in range(steps):
            sel = np.nonzero((ddev == d) & (rel == k) & keep)[0]
            buckets[(d, k)] = sel
            emax = max(emax, len(sel))
    emax = int(np.ceil(emax / pad_multiple)) * pad_multiple
    shape = (p, steps, emax)
    src_l = np.zeros(shape, np.int32)
    dst_l = np.zeros(shape, np.int32)
    mask = np.zeros(shape, bool)
    coeff_l = np.zeros(shape, np.float32) if coeff is not None else None
    for (d, k), sel in buckets.items():
        e = len(sel)
        src_l[d, k, :e] = src[sel] % n_local
        dst_l[d, k, :e] = dst[sel] % n_local
        mask[d, k, :e] = True
        if coeff_l is not None:
            coeff_l[d, k, :e] = np.asarray(coeff)[sel]
    if coeff_l is not None:
        return src_l, dst_l, mask, coeff_l, n_local
    return src_l, dst_l, mask, n_local


def bucket_counts(src: torch.Tensor, dst: torch.Tensor, n_local: int, p: int,
                  steps: int) -> torch.Tensor:
    """Edges per (dst rank, ring step) bucket, i64[p, steps], of the edges
    the band keeps."""
    rel = torch.remainder(src // n_local - dst // n_local, p)
    keep = rel < steps
    flat = (dst[keep] // n_local) * steps + rel[keep]
    return torch.bincount(flat, minlength=p * steps).reshape(p, steps)


def cube_nbytes(counts: torch.Tensor, pad_multiple: int = 8) -> int:
    """Bytes of ``bucket_edges``' cubes (src_l i32 + dst_l i32 + mask bool)
    for these bucket counts, as the reference holds them."""
    p, steps = counts.shape
    emax = max(int(counts.max()) if counts.numel() else 1, 1)
    emax = -(-emax // pad_multiple) * pad_multiple
    return p * steps * emax * (4 + 4 + 1)


class RingSpmm:
    """One direction's ring over this rank's buckets: x [n_local, D] (this
    rank's block of the unified rows) -> this rank's block of A x.

    ``src``/``dst`` are global unified row ids (int64 tensors on the
    device); this rank keeps the edges whose dst it owns and sorts them by
    (ring step, local dst), stably, into one CSR per step.  Every rank of
    ``group`` calls the ring together (each call is a collective)."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n_local: int,
                 p: int, rank: int, group, n_steps: int | None = None,
                 quantize: bool = False, impl: str | None = None):
        self.n_local, self.p, self.rank, self.group = n_local, p, rank, group
        self.steps = p if n_steps is None else int(n_steps)
        self.quantize = bool(quantize)
        self.impl = impl
        counts = bucket_counts(src, dst, n_local, p, self.steps)
        self.ref_nbytes = cube_nbytes(counts)
        mine = (dst // n_local) == rank
        s, d = src[mine], dst[mine] - rank * n_local
        rel = torch.remainder(s // n_local - rank, p)
        keep = rel < self.steps
        s, d, rel = s[keep], d[keep], rel[keep]
        # one stable sort by (step, local dst): each step's edges form a CSR
        order = torch.sort(rel * n_local + d, stable=True).indices
        per_row = torch.bincount(rel * n_local + d,
                                 minlength=self.steps * n_local)
        ptr = torch.zeros(self.steps * n_local + 1, dtype=torch.int64,
                          device=src.device)
        torch.cumsum(per_row, 0, out=ptr[1:])
        self._src = torch.remainder(s[order], n_local).to(torch.int32)
        self.indptr, self.src = [], []
        for k in range(self.steps):
            lo = ptr[k * n_local]
            rows = ptr[k * n_local:(k + 1) * n_local + 1]
            self.indptr.append((rows - lo).contiguous())
            hi = int(rows[-1])
            self.src.append(self._src[int(lo):hi])
        self.rotations = 0
        self.payload_bytes = 0

    def nbytes(self) -> int:
        """Bytes this rank holds for its buckets (row pointers + sources)."""
        return (sum(t.numel() * 8 for t in self.indptr)
                + self._src.numel() * 4)

    def _step(self, x: torch.Tensor, k: int) -> torch.Tensor:
        return kops.spmm_csr("sum", x, self.indptr[k], self.src[k],
                             self.n_local, gather=True, impl=self.impl)

    def _rotate(self, payload):
        """Start sending ``payload`` to rank r − 1 and receiving rank r + 1's
        into fresh buffers; returns (requests, the receive buffers)."""
        nxt = tuple(torch.empty_like(t) for t in payload)
        to, frm = (self.rank - 1) % self.p, (self.rank + 1) % self.p
        ops = [dist.P2POp(dist.isend, t, to, self.group) for t in payload]
        ops += [dist.P2POp(dist.irecv, t, frm, self.group) for t in nxt]
        self.rotations += 1
        self.payload_bytes += sum(t.numel() * t.element_size()
                                  for t in payload)
        return dist.batch_isend_irecv(ops), nxt

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        payload = None
        if self.steps > 1 and self.quantize:
            # the whole block as one row: one scale, the reference's
            # arithmetic (tensor divisor, round half to even, ±127)
            q, scale = quantize_rows_int8_tensor(x.reshape(1, -1))
            payload = (q.reshape(x.shape), scale.reshape(1))
        elif self.steps > 1:
            payload = (x,)
        acc = None
        for k in range(self.steps):
            reqs = None
            if k + 1 < self.steps:
                reqs, nxt = self._rotate(payload)
            if k == 0:
                xk = x                       # the exact resident block
            elif self.quantize:
                xk = payload[0].to(torch.float32) * payload[1]
            else:
                xk = payload[0]
            out = self._step(xk, k)
            acc = out if acc is None else acc.add_(out)
            if reqs is not None:
                for r in reqs:
                    r.wait()
                payload = nxt
        return acc

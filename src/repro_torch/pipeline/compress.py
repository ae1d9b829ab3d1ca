"""GradCompressor — the compressed gradient combine of one pipeline (the
port of ``repro/pipeline/compress.py``).

When ``CompressionCfg.grads`` selects a scheme, the exact fp32 gradient
passes through the compression primitives of ``optim.compression`` before
the optimizer sees it:

  ``int8``  stochastic per-tensor int8 quantization, dequantized (what an
            integer all-reduce would deliver; 1/4 the bytes on the wire);
  ``topk``  the k = frac x size largest-|.| entries kept, the rest zero
            (k values + k indices on the wire).

Error feedback (``error_feedback=True``, the default) carries each leaf's
compression residual into its next step, which keeps both schemes on the
exact trajectory instead of a biased neighbourhood.  On one device the
exchange is the identity: one share, no collective.

A sharded run (``_combine_sharded``) follows the reference's per-device
decomposition: the already combined gradient ``g`` is split into P equal
shares ``g/P`` (they sum to the exact gradient), each rank adds its
residual ``ef[rank]`` to its share and compresses it with a generator of
its own, and the exchange is the real collective over the process group:
an int32 all-reduce of the int8 payloads under an all-reduced max scale,
or an all-gather of every rank's top-k values and indices.  The residuals
are one ``[P, *leaf.shape]`` stack per parameter, row-sharded like every
other table, so each rank holds its ``[1, *shape]`` row.

**The key.**  ``jax.random`` keys mean nothing to torch, so the port's
``state["comp"]["key"]`` is its own: an int64 CPU tensor ``[seed, step]``.
Each call seeds one ``torch.Generator`` per (seed, step, leaf) through
``numpy.random.SeedSequence`` (a sharded run: one per (seed, step, leaf,
rank)) and advances ``step``, so the key
checkpoints as a plain leaf and a resumed run draws what the
uninterrupted one draws.  The reference's key is a uint32 array; a
checkpoint that carries one is refused on restore
(``checkpoint.restore_checkpoint`` refuses a leaf of another dtype kind),
never silently re-seeded.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.collectives import rank_of
from repro_torch.optim.compression import (dequantize_int8,
                                           psum_int8_with_residual,
                                           quantize_int8, topk_allgather_sum,
                                           topk_densify, topk_sparsify,
                                           wire_bytes)
from repro_torch.optim.optimizers import tree_leaves, tree_map

SCHEMES = ("int8", "topk")


class GradCompressor:
    """Compressed combine: ``(grads, comp) -> (combined, comp')``.

    ``comp`` is the compressor's slice of the training state: ``{"key":
    int64 [seed, step]}`` plus, under error feedback, ``{"ef": residual
    tree}`` with one ``[P, *leaf.shape]`` stack per parameter (the
    reference's layout, so its residuals restore; a sharded rank holds its
    ``[1, *shape]`` row).  ``grads`` are whole leaves on every rank."""

    def __init__(self, scheme: str, frac: float = 0.01,
                 error_feedback: bool = True, shard=None, group=None):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown compression scheme {scheme!r}; "
                             f"known: {SCHEMES} (or 'none' = no compressor)")
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"compression frac must be in (0, 1], "
                             f"got {frac}")
        self.scheme = scheme
        self.frac = float(frac)
        self.error_feedback = bool(error_feedback)
        self.shard = shard if shard is not None and shard.is_sharded \
            else None
        self.group = group if self.shard is not None else None

    # ------------------------------------------------------------ state
    @property
    def n_shares(self) -> int:
        return self.shard.n_shards if self.shard is not None else 1

    def init_state(self, params, seed: int):
        """The ``state["comp"]`` slice: a key decorrelated from the model
        init's seed, and zero residual stacks under error feedback."""
        comp = {"key": torch.tensor([(int(seed) ^ 0x5EEDC0DE) & 0x7FFFFFFF,
                                     0], dtype=torch.int64)}
        if self.error_feedback:
            comp["ef"] = self._zeros_ef(params, self.n_shares)
        return comp

    @staticmethod
    def _zeros_ef(grads, p: int = 1):
        return tree_map(lambda g: torch.zeros((p,) + tuple(g.shape),
                                              dtype=g.dtype,
                                              device=g.device), grads)

    # ------------------------------------------------------------ combine
    def __call__(self, grads, comp):
        seed, step = (int(v) for v in comp["key"].tolist())
        ef = comp["ef"] if self.error_feedback else self._zeros_ef(grads)
        if self.shard is not None:
            combined, new_ef = self._combine_sharded(grads, ef, seed, step)
        else:
            combined, new_ef = self._combine_single(grads, ef, seed, step)
        out = {"key": torch.tensor([seed, step + 1], dtype=torch.int64)}
        if self.error_feedback:
            out["ef"] = new_ef
        return combined, out

    @staticmethod
    def _generator(seed: int, step: int, leaf: int, device: torch.device,
                   rank: int | None = None) -> torch.Generator:
        """The generator of one (seed, step, leaf) — and rank, when
        sharded."""
        entropy = [seed, step, leaf] + ([] if rank is None else [rank])
        hi, lo = np.random.SeedSequence(entropy) \
            .generate_state(2, np.uint32)
        gen = torch.Generator(device=device)
        gen.manual_seed(((int(hi) << 32) | int(lo)) & 0x7FFFFFFFFFFFFFFF)
        return gen

    def _compress_share(self, share, seed: int, step: int, leaf: int):
        """One share's (combined contribution, residual) under the scheme:
        collective-free, the single-device exchange is the identity."""
        if self.scheme == "int8":
            q, scale = quantize_int8(
                share, self._generator(seed, step, leaf, share.device))
            g_hat = dequantize_int8(q, scale)
            return g_hat, share - g_hat
        k = max(1, int(share.numel() * self.frac))
        vals, idx, residual = topk_sparsify(share, k)
        return topk_densify(vals, idx, share.shape), residual

    def _combine_single(self, grads, ef, seed: int, step: int):
        outs, resids = [], []
        for i, (g, e) in enumerate(zip(tree_leaves(grads), tree_leaves(ef))):
            g_hat, r = self._compress_share(g + e[0], seed, step, i)
            outs.append(g_hat)
            resids.append(r[None])
        outs, resids = iter(outs), iter(resids)
        return (tree_map(lambda _: next(outs), grads),
                tree_map(lambda _: next(resids), grads))

    def _combine_sharded(self, grads, ef, seed: int, step: int):
        """Every rank compresses its share ``g/P + ef[rank]`` under its own
        generator and the exchange is the collective over the group:
        (combined gradient, this rank's [1, *shape] residual) per leaf."""
        p = self.shard.n_shards
        rank = rank_of(self.group)
        outs, resids = [], []
        for i, (g, e) in enumerate(zip(tree_leaves(grads), tree_leaves(ef))):
            share = g / p + e[0]
            if self.scheme == "int8":
                gen = self._generator(seed, step, i, share.device, rank)
                combined, r = psum_int8_with_residual(share, gen, self.group)
            else:
                k = max(1, int(share.numel() * self.frac))
                vals, idx, r = topk_sparsify(share, k)
                combined = topk_allgather_sum(vals, idx, share.shape,
                                              self.group)
            outs.append(combined)
            resids.append(r[None])
        outs, resids = iter(outs), iter(resids)
        return (tree_map(lambda _: next(outs), grads),
                tree_map(lambda _: next(resids), grads))

    # ------------------------------------------------------------ pricing
    def wire_bytes_per_step(self, params) -> tuple[int, int]:
        """(compressed, exact) bytes one participant puts on the wire per
        combine."""
        comp = exact = 0
        for g in tree_leaves(params):
            n = int(np.prod(g.shape))
            comp += wire_bytes(n, self.scheme, self.frac)
            exact += wire_bytes(n, "none")
        return comp, exact

    def describe(self) -> str:
        ef = "+ef" if self.error_feedback else ""
        tk = f" frac={self.frac}" if self.scheme == "topk" else ""
        where = f"mesh P={self.n_shares}" if self.shard is not None \
            else "single"
        return f"GradCompressor[{self.scheme}{ef}{tk}] ({where})"

"""Deterministic, resumable, shard-aware minibatch iterator (the port of
``repro/data/loader.py``): the same seed gives the same batches, byte for
byte.

The iterator state is (epoch, step); ``state_dict``/``load_state_dict``
round-trip exactly, so a restarted job resumes mid-epoch on the same
sample order.  Each data-parallel worker takes a strided slice of the
per-epoch permutation.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    step: int = 0


class EdgeLoader:
    """Iterates (user, pos_item) interaction minibatches."""

    def __init__(self, user: np.ndarray, item: np.ndarray, batch: int,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 drop_last: bool = True):
        if len(user) != len(item):
            raise ValueError("user and item must have one entry per edge")
        self.user, self.item = user, item
        self.batch = batch
        self.seed = seed
        self.shard_id, self.num_shards = shard_id, num_shards
        self.drop_last = drop_last
        self.state = LoaderState()
        self._perm: tuple[int, np.ndarray] | None = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        # The reference draws the epoch's permutation anew on every batch;
        # it depends on (seed, epoch) only, so the port keeps the current
        # epoch's copy.  The batches are the same bytes; at 15M edges a
        # fresh draw per microbatch would cost seconds of host time.
        if self._perm is None or self._perm[0] != epoch:
            rng = np.random.default_rng((self.seed, epoch))
            perm = rng.permutation(len(self.user))
            self._perm = (epoch, perm[self.shard_id::self.num_shards])
        return self._perm[1]

    def steps_per_epoch(self) -> int:
        # arithmetic count of this shard's strided slice
        n = len(range(self.shard_id, len(self.user), self.num_shards))
        return n // self.batch if self.drop_last else -(-n // self.batch)

    def __iter__(self):
        return self

    def __next__(self):
        if self.state.step >= self.steps_per_epoch():
            self.state = LoaderState(self.state.epoch + 1, 0)
        perm = self._epoch_perm(self.state.epoch)
        lo = self.state.step * self.batch
        idx = perm[lo:lo + self.batch]
        self.state = LoaderState(self.state.epoch, self.state.step + 1)
        return self.user[idx], self.item[idx]

    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = LoaderState(**d)

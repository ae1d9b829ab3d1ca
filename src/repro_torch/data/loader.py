"""Deterministic, resumable, shard-aware minibatch iterator (the port of
``repro/data/loader.py``): the same seed gives the same batches, byte for
byte.

The iterator state is (epoch, step); ``state_dict``/``load_state_dict``
round-trip exactly, so a restarted job resumes mid-epoch on the same
sample order.  Each data-parallel worker takes a strided slice of the
per-epoch permutation.

The next epoch's permutation is drawn one epoch ahead, off the caller's
path: when the loader hands over epoch e's permutation it starts drawing
e+1's on a thread of its own (numpy's shuffle runs without the GIL), and
takes it at the next hand-over, waiting for it if it has not finished.
The draw is the inline draw's call, so the bytes are the same.  A draw
for another epoch (after ``load_state_dict`` or a changed ``state``),
seed or shard is waited for and dropped, and the loader draws inline:
one draw at a time, so at most two permutations are alive.  The spans
``step::perm`` (every hand-over) and ``step::perm_draw`` (every inline
draw) count the hand-overs and the misses.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch import trace


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    step: int = 0


def _draw(seed: int, epoch: int, n: int, shard_id: int,
          num_shards: int) -> np.ndarray:
    """The epoch's permutation of n edge ids, this shard's strided slice."""
    rng = np.random.default_rng((seed, epoch))
    perm = rng.permutation(n)
    return perm[shard_id::num_shards]


class _Ahead:
    """One epoch's permutation drawn on a thread of its own; ``key`` is
    ``_draw``'s arguments."""

    def __init__(self, key: tuple):
        self.key = key
        self._perm = self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"edge-perm-{key[1]}")
        self._thread.start()

    def _run(self) -> None:
        try:
            self._perm = _draw(*self.key)
        except Exception as e:          # raised again by take()
            self._error = e

    def take(self) -> np.ndarray:
        """The permutation, once drawn (the draw's error, if it raised)."""
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._perm


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
        self._perm: tuple[tuple, np.ndarray] | None = None
        self._ahead: _Ahead | None = None   # the next epoch's draw

    def _key(self, epoch: int) -> tuple:
        return (self.seed, epoch, len(self.user), self.shard_id,
                self.num_shards)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        # The reference draws the epoch's permutation anew on every batch;
        # it depends on (seed, epoch) only, so the port keeps the current
        # epoch's copy.  The batches are the same bytes; at 15M edges a
        # fresh draw per microbatch would cost seconds of host time.  The
        # next epoch's is drawn from the same call on a thread while this
        # one is consumed (the module's doc).
        key = self._key(epoch)
        if self._perm is None or self._perm[0] != key:
            with trace.span("step::perm"):
                ahead, self._ahead = self._ahead, None
                perm = ahead.take() if ahead is not None else None
                if ahead is None or ahead.key != key:
                    with trace.span("step::perm_draw"):
                        perm = _draw(*key)
                self._perm = (key, perm)
                self._ahead = _Ahead(self._key(epoch + 1))
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

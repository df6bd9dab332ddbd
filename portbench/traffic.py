"""The one traffic generator: global batches of a training cell.

A traffic file (``traffic/<name>.json``) gives the stream's parameters
(``stream``: :class:`portbench.stream.StreamConfig`'s fields, its ``seed``
among them) and a ``pool`` size. The pool is the stream's first ``pool``
global batches, by their sample lengths: every run of a cell trains on the
same set of sizes, whatever its ``--seed``. The run's seed orders them
(one permutation per pass over the pool) and draws every token afresh, so
that no two iterations of a run share a row. A pass over the pool is a
cycle: the first one warms up every shape the run will use, and the
measured window is whole cycles.
"""
from __future__ import annotations

import numpy as np

from portbench.stream import GlobalBatch, MultiTaskStream, StreamConfig

_ORDER_SALT = 0x0D3E
_TOKEN_SALT = 0x70CE


class CellTraffic:
    """``batch(i)``: the i-th global batch of a run with ``seed``, a pure
    function of (traffic file, vocabulary, seed, i)."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec = spec
        self.vocab = int(vocab)
        self.seed = int(seed)
        stream = MultiTaskStream(StreamConfig(vocab=self.vocab,
                                              **spec["stream"]))
        self.pool = [stream.batch(i) for i in range(int(spec["pool"]))]

    @property
    def cycle(self) -> int:
        return len(self.pool)

    def pool_index(self, i: int) -> int:
        c, j = divmod(int(i), self.cycle)
        rng = np.random.default_rng([self.seed, _ORDER_SALT, c])
        return int(rng.permutation(self.cycle)[j])

    def batch(self, i: int) -> GlobalBatch:
        src = self.pool[self.pool_index(i)]
        rng = np.random.default_rng([self.seed, _TOKEN_SALT, int(i)])
        tokens = [rng.integers(0, self.vocab, int(n), dtype=np.int32)
                  for n in src.lengths.sum(axis=1)]
        return GlobalBatch(iteration=int(i), lengths=src.lengths.copy(),
                           task_ids=src.task_ids.copy(), tokens=tokens)

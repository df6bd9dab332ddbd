"""TPU shape palette — the central hardware adaptation (DESIGN §3).

XLA compiles one executable per input shape, so DynaPipe's continuous
(micro_batch_size × seq_len) shape domain must be quantized to a finite
palette. The DP splitter charges every candidate micro-batch its *bucketed*
cost, so the optimizer minimizes the real padded cost it will pay, and the
number of distinct compiled executables is bounded by ``len(palette)``.

Buckets: seq lengths grow geometrically (ratio default 1.333, snapped to
multiples of 128 for MXU/lane alignment); micro-batch sizes are powers of
two up to ``max_mbs``. Worst-case padding waste from bucketing alone is
``ratio - 1`` (~33 %) but the DP almost always lands near bucket edges since
it sees the bucketed cost.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass

import numpy as np


def _snap(n: int, align: int) -> int:
    return max(align, -(-n // align) * align)


@dataclass(frozen=True)
class ShapePalette:
    seq_buckets: tuple[int, ...]
    mbs_buckets: tuple[int, ...]

    @classmethod
    def build(cls, min_seq: int = 128, max_seq: int = 32768, ratio: float = 4 / 3,
              max_mbs: int = 512, seq_align: int = 128) -> "ShapePalette":
        seqs = []
        s = float(min_seq)
        while s < max_seq:
            v = _snap(int(round(s)), seq_align)
            if not seqs or v > seqs[-1]:
                seqs.append(v)
            s *= ratio
        if not seqs or seqs[-1] < max_seq:
            seqs.append(max_seq)
        mbs = [1 << i for i in range(int(math.log2(max_mbs)) + 1)]
        return cls(tuple(seqs), tuple(mbs))

    def bucket_seq(self, seq_len: int) -> int:
        i = bisect.bisect_left(self.seq_buckets, seq_len)
        if i >= len(self.seq_buckets):
            raise ValueError(f"seq_len {seq_len} exceeds palette max "
                             f"{self.seq_buckets[-1]}")
        return self.seq_buckets[i]

    def bucket_mbs(self, mbs: int) -> int:
        i = bisect.bisect_left(self.mbs_buckets, mbs)
        if i >= len(self.mbs_buckets):
            raise ValueError(f"micro-batch size {mbs} exceeds palette max "
                             f"{self.mbs_buckets[-1]}")
        return self.mbs_buckets[i]

    def bucket(self, mbs: int, seq_len: int) -> tuple[int, int]:
        return self.bucket_mbs(mbs), self.bucket_seq(seq_len)

    # ----------------- vectorized variants (fast planning path) -----------
    # Both return (bucketed_values, overflow_mask): out-of-palette inputs are
    # clamped to the top bucket and flagged instead of raising, so callers
    # evaluating whole banded tables at once can decide per group (the DP
    # treats an overflowing multi-sample group as infeasible; a single
    # sample that overflows is a hard error).
    def bucket_seq_array(self, seq_lens: np.ndarray):
        b = np.asarray(self.seq_buckets, dtype=np.int64)
        i = np.searchsorted(b, seq_lens)
        overflow = i >= len(b)
        return b[np.minimum(i, len(b) - 1)], overflow

    def bucket_mbs_array(self, mbs: np.ndarray):
        b = np.asarray(self.mbs_buckets, dtype=np.int64)
        i = np.searchsorted(b, mbs)
        overflow = i >= len(b)
        return b[np.minimum(i, len(b) - 1)], overflow

    def n_shapes(self) -> int:
        return len(self.seq_buckets) * len(self.mbs_buckets)


IDENTITY = None  # sentinel: callers treat a None palette as no bucketing

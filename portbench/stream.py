# Frozen copy of src/repro_torch/data/streams.py at commit
# 6c281531521ac131e36dd31e0d5322d0dc64508a: the yardstick's traffic generator.
# Later changes to the program's stream do not reach the benchmark.
"""Deterministic multi-task data streams (the plan-ahead runtime's feed).

The paper's workload (FLANv2 zero-shot) mixes ~1836 tasks whose mean lengths
span 50 to ~1000 tokens with a heavy right tail (Fig. 1b). ``MultiTaskStream``
synthesizes that shape as a *stream of global batches*: per-task lognormal
length distributions, a Pareto-tail mixture component (the long-tail samples
where static padding loses hardest — cf. FlexSP's skewed-workload modeling),
an optional encoder/decoder task fraction, and token-budgeted batch sizing.

The property the plan-ahead runtime needs is **counter-based determinism**:
``stream.batch(k)`` is a pure function of ``(StreamConfig, k)``, seeded via
``np.random.default_rng([seed, salt, k])`` (a SeedSequence spawn, stable
across processes and platforms). Any worker — a planner process, a replica,
a restarted job — regenerates bit-identical batch *k* without replaying
batches ``0..k-1``, so planning iteration k+1 in another process needs only
the integer ``k+1``, never the arrays.

Token ids carry a task-conditional affine-bigram structure (as in
``data/synthetic.py``) so CPU end-to-end examples have a learnable signal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

_TASK_SALT = 0x5EED
_BATCH_SALT = 7919


@dataclass(frozen=True)
class StreamTask:
    """One synthetic task family: length statistics + token-structure knobs."""

    task_id: int
    mean_log_enc: float
    sigma_enc: float
    mean_log_dec: float
    sigma_dec: float
    weight: float
    encdec: bool
    bigram_a: int
    bigram_b: int


@dataclass(frozen=True)
class StreamConfig:
    """Everything that determines the stream; two equal configs yield
    bit-identical streams in any process."""

    n_tasks: int = 64
    global_tokens: int = 16384  # token budget per global batch (paper: 65536)
    max_len: int = 2048
    vocab: int = 32000
    encdec_fraction: float = 0.0  # fraction of tasks with a decoder target
    tail_fraction: float = 0.08  # per-sample Pareto-tail mixture weight
    tail_alpha: float = 1.1  # smaller = heavier tail
    min_samples: int = 2
    seed: int = 0


@dataclass
class GlobalBatch:
    """One iteration's mini-batch: lengths feed the planner, tokens feed the
    executor's micro-batch materialization."""

    iteration: int
    lengths: np.ndarray  # (n, 2) int64 (enc_len, dec_len); dec==0 dec-only
    task_ids: np.ndarray  # (n,) int64
    tokens: list[np.ndarray]  # per-sample int32 id streams, len enc+dec

    @property
    def n_samples(self) -> int:
        return len(self.lengths)

    @property
    def total_tokens(self) -> int:
        return int(self.lengths.sum())

    @property
    def has_decoder(self) -> bool:
        """True when any sample carries a decoder target (2D workload)."""
        return bool(np.any(self.lengths[:, 1]))

    # Each sample's id stream concatenates its encoder and decoder tokens;
    # the per-sample (enc_len, dec_len) pair is the split point. These views
    # are what the enc-dec micro-batch materialization consumes.
    def enc_tokens(self, i: int) -> np.ndarray:
        return self.tokens[i][: int(self.lengths[i, 0])]

    def dec_tokens(self, i: int) -> np.ndarray:
        e = int(self.lengths[i, 0])
        return self.tokens[i][e : e + int(self.lengths[i, 1])]


def make_stream_tasks(cfg: StreamConfig) -> list[StreamTask]:
    """Task mixture derived deterministically from the config seed: log-uniform
    length scales (~32..4000 tokens), power-law sampling weights."""
    rng = np.random.default_rng([cfg.seed, _TASK_SALT])
    hi = max(64.0, min(4000.0, float(cfg.max_len)))
    tasks = []
    for t in range(cfg.n_tasks):
        tasks.append(
            StreamTask(
                task_id=t,
                mean_log_enc=rng.uniform(np.log(32.0), np.log(hi)),
                sigma_enc=rng.uniform(0.3, 0.9),
                mean_log_dec=rng.uniform(np.log(4.0), np.log(256.0)),
                sigma_dec=rng.uniform(0.3, 0.8),
                weight=float((t + 1) ** -0.8),
                encdec=bool(rng.random() < cfg.encdec_fraction),
                bigram_a=31 + 2 * (t % 13),
                bigram_b=7 + (t % 97),
            )
        )
    return tasks


class MultiTaskStream:
    """Iterator over token-budgeted global batches; ``batch(k)`` is pure."""

    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        self.tasks = make_stream_tasks(cfg)
        w = np.array([t.weight for t in self.tasks])
        self._w = w / w.sum()

    # ------------------------------------------------------------------
    def _sample_lengths(self, rng: np.random.Generator, task: StreamTask):
        cfg = self.cfg
        enc = rng.lognormal(task.mean_log_enc, task.sigma_enc)
        if rng.random() < cfg.tail_fraction:
            enc *= 1.0 + rng.pareto(cfg.tail_alpha)
        enc = int(np.clip(enc, 4, cfg.max_len))
        dec = 0
        if task.encdec:
            dec = int(
                np.clip(
                    rng.lognormal(task.mean_log_dec, task.sigma_dec),
                    2,
                    max(2, cfg.max_len // 4),
                )
            )
            enc = min(enc, cfg.max_len - dec)  # total stays materializable
        return enc, dec

    def _sample_tokens(self, rng: np.random.Generator, task: StreamTask, n: int):
        s0 = int(rng.integers(0, self.cfg.vocab))
        a, b, v = task.bigram_a, task.bigram_b, self.cfg.vocab
        # closed form of the affine bigram next = (prev*a + b) % v:
        #   s_j = (a^j * s0 + b * T_j) mod v,  T_j = sum_{i<j} a^i mod v.
        # P (powers) and T (partial sums) extend by doubling —
        #   P[m+i] = a^m P[i],  T[m+i] = T_m + a^m T_i  (all mod v) —
        # so a length-n stream is O(log n) vectorized ops instead of n
        # Python iterations; values are bit-identical to the scalar loop.
        p = np.array([1], dtype=np.int64)
        t = np.array([0], dtype=np.int64)
        while len(p) < n:
            pm = (p[-1] * a) % v  # a^m for m = len(p)
            tm = (t[-1] + p[-1]) % v  # T_m
            p = np.concatenate([p, (pm * p) % v])
            t = np.concatenate([t, (tm + pm * t) % v])
        seq = (p[:n] * s0 + b * t[:n]) % v
        return seq.astype(np.int32)

    def batch(self, iteration: int) -> GlobalBatch:
        """Global batch ``iteration``, independent of any other call."""
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, _BATCH_SALT, int(iteration)])
        lengths: list[tuple[int, int]] = []
        task_ids: list[int] = []
        tokens: list[np.ndarray] = []
        total = 0
        while total < cfg.global_tokens or len(lengths) < cfg.min_samples:
            tid = int(rng.choice(cfg.n_tasks, p=self._w))
            task = self.tasks[tid]
            enc, dec = self._sample_lengths(rng, task)
            lengths.append((enc, dec))
            task_ids.append(tid)
            tokens.append(self._sample_tokens(rng, task, enc + dec))
            total += enc + dec
        return GlobalBatch(
            iteration=int(iteration),
            lengths=np.asarray(lengths, dtype=np.int64),
            task_ids=np.asarray(task_ids, dtype=np.int64),
            tokens=tokens,
        )

    def __iter__(self) -> Iterator[GlobalBatch]:
        it = 0
        while True:
            yield self.batch(it)
            it += 1

    # ------------------------------------------------------------------
    def length_stats(self, n_batches: int = 8) -> dict:
        """Pooled length statistics over the first ``n_batches`` batches —
        the skew numbers (p95/p50) the paper's Fig. 1b argument rests on."""
        pooled = np.concatenate(
            [self.batch(i).lengths.sum(axis=1) for i in range(n_batches)]
        )
        p50, p95 = np.percentile(pooled, [50, 95])
        return {
            "n_samples": int(len(pooled)),
            "mean": float(pooled.mean()),
            "p50": float(p50),
            "p95": float(p95),
            "max": int(pooled.max()),
            "skew_p95_over_p50": float(p95 / max(p50, 1.0)),
        }

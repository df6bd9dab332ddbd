"""Synthetic multi-task dataset with FLANv2-like sequence-length statistics.

The paper's workload (FLANv2 zero-shot) mixes ~1836 tasks whose lengths span
tens of tokens (e.g. MNLI, mean 51.6) to thousands (CNN/DailyMail, mean
977.7) with a heavy right tail (paper Fig. 1b, log-scale y). We model each
task family as a lognormal over lengths and sample tasks from a power-law
mixture — enough structure to reproduce the >80 % naive-padding waste the
paper reports (§2.1) and the padding-efficiency numbers of Fig. 15.

Samples are (task_id, enc_len, dec_len) triples plus a deterministic token
stream (for the end-to-end CPU training examples we synthesize token ids with
a task-dependent bigram structure so the loss measurably decreases).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TaskSpec:
    task_id: int
    mean_log_enc: float
    sigma_enc: float
    mean_log_dec: float
    sigma_dec: float
    weight: float


def make_tasks(n_tasks: int = 64, seed: int = 0) -> list[TaskSpec]:
    rng = np.random.default_rng(seed)
    tasks = []
    # task length scales span ~32 .. ~4000 tokens, log-uniform
    for t in range(n_tasks):
        mean_enc = rng.uniform(np.log(32), np.log(4000))
        mean_dec = rng.uniform(np.log(4), np.log(256))
        tasks.append(TaskSpec(
            task_id=t,
            mean_log_enc=mean_enc,
            sigma_enc=rng.uniform(0.3, 0.9),
            mean_log_dec=mean_dec,
            sigma_dec=rng.uniform(0.3, 0.8),
            weight=float((t + 1) ** -0.8),      # power-law task mixture
        ))
    return tasks


class MultiTaskDataset:
    def __init__(self, n_tasks: int = 64, max_len: int = 8192, seed: int = 0,
                 encdec: bool = False):
        self.tasks = make_tasks(n_tasks, seed)
        self.max_len = max_len
        self.encdec = encdec
        self._w = np.array([t.weight for t in self.tasks])
        self._w = self._w / self._w.sum()
        self.rng = np.random.default_rng(seed + 1)

    def sample_lengths(self, n: int) -> np.ndarray:
        """(n, 2) int array of (enc_len, dec_len); dec==0 for decoder-only."""
        tid = self.rng.choice(len(self.tasks), size=n, p=self._w)
        out = np.zeros((n, 2), dtype=np.int64)
        for i, t in enumerate(tid):
            ts = self.tasks[t]
            enc = int(np.clip(self.rng.lognormal(ts.mean_log_enc, ts.sigma_enc),
                              4, self.max_len))
            dec = 0
            if self.encdec:
                dec = int(np.clip(self.rng.lognormal(ts.mean_log_dec, ts.sigma_dec),
                                  2, self.max_len // 4))
            out[i] = (enc, dec)
        self._last_tasks = tid
        return out

    def sample_minibatch(self, n: int, vocab: int):
        """lengths + token streams with learnable (task-conditional bigram)
        structure for the CPU end-to-end training examples."""
        lengths = self.sample_lengths(n)
        tid = self._last_tasks
        tokens = []
        for i in range(n):
            ln = int(lengths[i].sum()) or 1
            # deterministic per-task bigram: next = (prev * a + b) % vocab
            a = 31 + 2 * int(tid[i] % 13)
            b = 7 + int(tid[i] % 97)
            seq = np.zeros(ln, dtype=np.int32)
            seq[0] = int(self.rng.integers(0, vocab))
            for j in range(1, ln):
                seq[j] = (seq[j - 1] * a + b) % vocab
            tokens.append(seq)
        return lengths, tokens, tid


def minibatches_by_token_budget(dataset: MultiTaskDataset, global_tokens: int,
                                n_iters: int):
    """The paper fixes the global batch in tokens (e.g. 65536); yield length
    arrays whose total is ~global_tokens."""
    for _ in range(n_iters):
        lengths = []
        total = 0
        while total < global_tokens:
            l = dataset.sample_lengths(1)[0]
            lengths.append(l)
            total += int(l.sum())
        yield np.asarray(lengths)

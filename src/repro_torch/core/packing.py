"""Baselines the paper compares against (§2.2, §8: MLM+DS packing; Fig. 5 /
Fig. 16a: token-based and fixed-size micro-batching)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.microbatch import MicroBatch, _as2d


@dataclass
class PackedRow:
    sample_indices: list[int]
    used: int
    capacity: int


def pack_first_fit(lengths, max_len: int) -> list[PackedRow]:
    """Greedy first-fit-decreasing packing into rows of ``max_len`` tokens,
    truncating single samples longer than the row (the paper's MLM+DS
    baseline behaviour)."""
    L = _as2d(lengths).sum(axis=1)
    order = np.argsort(L)[::-1]
    rows: list[PackedRow] = []
    for idx in order:
        ln = min(int(L[idx]), max_len)
        for row in rows:
            if row.used + ln <= row.capacity:
                row.sample_indices.append(int(idx))
                row.used += ln
                break
        else:
            rows.append(PackedRow([int(idx)], ln, max_len))
    return rows


def pack_encdec_first_fit(lengths, max_enc: int, max_dec: int) -> list[list[int]]:
    """First-fit-decreasing packing of (enc, dec) pairs: a sample joins a
    row only if its encoder part fits the row's remaining enc budget AND its
    decoder part fits the dec budget (both sides of a pair must share the
    row for segment-matched cross-attention). Oversize singles are clipped
    to the budgets, mirroring :func:`pack_first_fit` truncation."""
    L = _as2d(lengths)
    order = np.argsort(L.sum(axis=1))[::-1]
    rows: list[list[int]] = []
    used: list[tuple[int, int]] = []          # (enc_used, dec_used) per row
    for idx in order:
        e = min(int(L[idx, 0]), max_enc)
        d = min(int(L[idx, 1]), max_dec)
        for r, (ue, ud) in enumerate(used):
            if ue + e <= max_enc and ud + d <= max_dec:
                rows[r].append(int(idx))
                used[r] = (ue + e, ud + d)
                break
        else:
            rows.append([int(idx)])
            used.append((e, d))
    return rows


def packing_micro_batches(lengths, max_len: int, rows_per_mb: int,
                          cost: CostModel) -> list[MicroBatch]:
    rows = pack_first_fit(lengths, max_len)
    out = []
    for i in range(0, len(rows), rows_per_mb):
        chunk = rows[i : i + rows_per_mb]
        idxs = [s for r in chunk for s in r.sample_indices]
        m = len(chunk)
        out.append(MicroBatch(
            idxs, len(idxs), m, max_len,
            cost.stage_fwd_time(m, max_len),
            cost.stage_bwd_time(m, max_len),
            cost.stage_act_memory(m, max_len),
        ))
    return out


def packing_efficiency(rows: list[PackedRow]) -> float:
    used = sum(r.used for r in rows)
    total = sum(r.capacity for r in rows)
    return used / max(total, 1)


def token_based_micro_batches(ordered_lengths, tokens_per_mb: int,
                              cost: CostModel) -> list[MicroBatch]:
    """Equal-token-count micro-batching (paper Fig. 5 'TB')."""
    L = _as2d(ordered_lengths)
    out, cur = [], []
    cur_max = np.zeros(2, dtype=np.int64)

    def flush():
        if not cur:
            return
        m = len(cur)
        enc, dec = int(cur_max[0]), int(cur_max[1])
        seq = (enc, dec) if dec else enc
        out.append(MicroBatch(
            list(cur), m, m, seq,
            cost.stage_fwd_time(m, seq), cost.stage_bwd_time(m, seq),
            cost.stage_act_memory(m, seq)))

    for i in range(len(L)):
        nmax = np.maximum(cur_max, L[i])
        if cur and (len(cur) + 1) * int(nmax.sum()) > tokens_per_mb:
            flush()
            cur, cur_max = [], np.zeros(2, dtype=np.int64)
            nmax = L[i].copy()
        cur.append(i)
        cur_max = nmax
    flush()
    return out


def fixed_size_micro_batches(ordered_lengths, mbs: int,
                             cost: CostModel) -> list[MicroBatch]:
    """Uniform micro-batch size (paper Fig. 5 right column)."""
    L = _as2d(ordered_lengths)
    out = []
    for i in range(0, len(L), mbs):
        grp = L[i : i + mbs]
        m = len(grp)
        enc, dec = int(grp[:, 0].max()), int(grp[:, 1].max())
        seq = (enc, dec) if dec else enc
        out.append(MicroBatch(
            list(range(i, i + m)), m, m, seq,
            cost.stage_fwd_time(m, seq), cost.stage_bwd_time(m, seq),
            cost.stage_act_memory(m, seq)))
    return out

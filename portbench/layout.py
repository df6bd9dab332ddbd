"""The micro-batch layout check: every sample of a global batch reaches the
step exactly once, with its tokens intact.

It reads the numpy micro-batches the program's materialisation made (the
port's batch dicts: one sample a row, or packed rows whose segment ids
mark the samples) against the global batch the harness generated, and
counts the samples that are missing, repeated or altered (tokens, labels,
loss weights, positions or segment ids). The count is exact: its limit is
0.
"""
from __future__ import annotations

import numpy as np


def _side_ok(b, row, start, n, seg, want, tok_key, pos_key, seg_key):
    sl = slice(start, start + n)
    return (np.array_equal(b[tok_key][row, sl], want)
            and np.array_equal(b[pos_key][row, sl], np.arange(n))
            and bool((b[seg_key][row, sl] == seg).all()))


def _labels_ok(b, row, start, want):
    n = len(want)
    sl = slice(start, start + n - 1)
    return (np.array_equal(b["labels"][row, sl], want[1:])
            and bool((b["loss_weights"][row, sl] == 1.0).all())
            and (n < 1 or float(b["loss_weights"][row, start + n - 1]) == 0.0))


def _segments(seg_row):
    """``[(segment id, start, length)]`` of a row's runs of ids >= 0."""
    out, i, n = [], 0, len(seg_row)
    while i < n:
        s = int(seg_row[i])
        j = i
        while j < n and int(seg_row[j]) == s:
            j += 1
        if s >= 0:
            out.append((s, i, j - i))
        i = j
    return out


def _expected(gb, s):
    e, d = (int(x) for x in gb.lengths[s])
    t = gb.tokens[s]
    return t[:e], t[e:e + d]


def sample_errors(gb, batches, rows) -> int:
    """Samples of ``gb`` not trained exactly once with their tokens intact.
    ``batches`` are the micro-batches as numpy dicts; ``rows`` gives, for
    each of them, each row's sample indices in order (one a row on the
    planner's path, several on packed rows)."""
    seen = np.zeros(gb.n_samples, dtype=np.int64)
    bad = set()
    for b, mb_rows in zip(batches, rows):
        encdec = "enc_tokens" in b
        for r, samples in enumerate(mb_rows):
            if encdec:
                eseg, dseg = (_segments(b["enc_segment_ids"][r]),
                              _segments(b["dec_segment_ids"][r]))
            else:
                eseg = _segments(b["segment_ids"][r])
            if len(eseg) != len(samples) or (encdec
                                             and len(dseg) != len(samples)):
                bad.update(int(s) for s in samples)
            for j, s in enumerate(samples):
                s = int(s)
                seen[s] += 1
                if j >= len(eseg) or (encdec and j >= len(dseg)):
                    bad.add(s)
                    continue
                enc, dec = _expected(gb, s)
                seg, start, n = eseg[j]
                if encdec:
                    dsg, dstart, dn = dseg[j]
                    ok = (n == len(enc) and dn == len(dec)
                          and _side_ok(b, r, start, n, seg, enc,
                                       "enc_tokens", "enc_positions",
                                       "enc_segment_ids")
                          and _side_ok(b, r, dstart, dn, dsg, dec,
                                       "dec_tokens", "dec_positions",
                                       "dec_segment_ids")
                          and _labels_ok(b, r, dstart, dec))
                else:
                    ok = (n == len(enc)
                          and _side_ok(b, r, start, n, seg, enc, "tokens",
                                       "positions", "segment_ids")
                          and _labels_ok(b, r, start, enc))
                if not ok:
                    bad.add(s)
    bad.update(int(s) for s in np.nonzero(seen != 1)[0])
    return len(bad)

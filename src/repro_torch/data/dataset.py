"""Micro-batch materialization: sample token streams -> padded JAX arrays.

Rows are padded to the micro-batch's bucketed (mbs, seq) shape; padding
carries segment_id -1 (masked from attention via the ragged kernel and from
the loss via loss_weights=0). Labels are next-token shifted within each
sample; position ids restart at 0 per sample.

Encoder-decoder micro-batches (``spec.seq`` a 2-tuple ``(enc, dec)`` with
``dec > 0``) materialize *separate* padded arrays per side:
``enc_tokens``/``enc_positions``/``enc_segment_ids`` at the bucketed enc
length and ``dec_tokens``/``dec_positions``/``dec_segment_ids`` plus
dec-side ``labels``/``loss_weights`` at the bucketed dec length (T5
convention: loss on decoder targets only). Each sample's id stream
concatenates enc then dec tokens, so the per-sample ``(enc_len, dec_len)``
pair from ``lengths`` is the split point — which is why 2D materialization
requires ``lengths``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.instructions import MicroBatchSpec


def materialize_micro_batch(spec: MicroBatchSpec, tokens: list[np.ndarray],
                            lengths: np.ndarray | None = None,
                            pad_id: int = 0):
    """tokens: full minibatch sample streams (indexed by spec.sample_indices).

    Decoder-only (int ``spec.seq``) returns
      tokens, labels (B,S) int32; loss_weights (B,S) f32;
      positions, segment_ids (B,S) int32.
    Encoder-decoder (tuple ``spec.seq``; needs ``lengths`` (n, 2)) returns
      enc_tokens/enc_positions/enc_segment_ids (B,Se),
      dec_tokens/dec_positions/dec_segment_ids/labels (B,Sd) int32;
      loss_weights (B,Sd) f32.
    """
    if isinstance(spec.seq, (tuple, list)):
        if lengths is None:
            raise ValueError(
                "enc-dec micro-batch (2D seq) needs per-sample lengths to "
                "split each token stream into its enc/dec parts — pass "
                "GlobalBatch.lengths")
        return _materialize_encdec(spec, tokens, np.asarray(lengths), pad_id)
    seq = spec.seq
    b = spec.mbs
    out_tok = np.full((b, seq), pad_id, dtype=np.int32)
    out_lab = np.zeros((b, seq), dtype=np.int32)
    out_w = np.zeros((b, seq), dtype=np.float32)
    out_pos = np.zeros((b, seq), dtype=np.int32)
    out_seg = np.full((b, seq), -1, dtype=np.int32)
    for row, sample_idx in enumerate(spec.sample_indices):
        t = tokens[sample_idx][:seq]
        n = len(t)
        out_tok[row, :n] = t
        if n > 1:
            out_lab[row, : n - 1] = t[1:]
            out_w[row, : n - 1] = 1.0
        out_pos[row, :n] = np.arange(n)
        out_seg[row, :n] = 0
    return {
        "tokens": out_tok,
        "labels": out_lab,
        "loss_weights": out_w,
        "positions": out_pos,
        "segment_ids": out_seg,
    }


def _materialize_encdec(spec: MicroBatchSpec, tokens: list[np.ndarray],
                        lengths: np.ndarray, pad_id: int):
    se, sd = int(spec.seq[0]), int(spec.seq[1])
    b = spec.mbs
    enc_tok = np.full((b, se), pad_id, dtype=np.int32)
    enc_pos = np.zeros((b, se), dtype=np.int32)
    enc_seg = np.full((b, se), -1, dtype=np.int32)
    dec_tok = np.full((b, sd), pad_id, dtype=np.int32)
    dec_pos = np.zeros((b, sd), dtype=np.int32)
    dec_seg = np.full((b, sd), -1, dtype=np.int32)
    out_lab = np.zeros((b, sd), dtype=np.int32)
    out_w = np.zeros((b, sd), dtype=np.float32)
    for row, sample_idx in enumerate(spec.sample_indices):
        le = min(int(lengths[sample_idx, 0]), se)
        ld = min(int(lengths[sample_idx, 1]), sd)
        t = tokens[sample_idx]
        enc_tok[row, :le] = t[:le]
        enc_pos[row, :le] = np.arange(le)
        enc_seg[row, :le] = 0
        if ld > 0:
            d = t[int(lengths[sample_idx, 0]):
                  int(lengths[sample_idx, 0]) + ld]
            dec_tok[row, :ld] = d
            dec_pos[row, :ld] = np.arange(ld)
            dec_seg[row, :ld] = 0
            if ld > 1:
                out_lab[row, : ld - 1] = d[1:]
                out_w[row, : ld - 1] = 1.0
    return {
        "enc_tokens": enc_tok,
        "enc_positions": enc_pos,
        "enc_segment_ids": enc_seg,
        "dec_tokens": dec_tok,
        "dec_positions": dec_pos,
        "dec_segment_ids": dec_seg,
        "labels": out_lab,
        "loss_weights": out_w,
    }


def materialize_packed_encdec_rows(rows, tokens: list[np.ndarray],
                                   lengths: np.ndarray, max_enc: int,
                                   max_dec: int, pad_id: int = 0):
    """Packing baseline for enc-dec: several samples share a row on *both*
    sides, with matching segment ids — decoder segment s cross-attends only
    encoder segment s (enforced by the segment-masked attention), so packed
    pairs stay isolated. ``rows`` are sample-index lists from
    :func:`repro_torch.core.packing.pack_encdec_first_fit`."""
    b = len(rows)
    enc_tok = np.full((b, max_enc), pad_id, dtype=np.int32)
    enc_pos = np.zeros((b, max_enc), dtype=np.int32)
    enc_seg = np.full((b, max_enc), -1, dtype=np.int32)
    dec_tok = np.full((b, max_dec), pad_id, dtype=np.int32)
    dec_pos = np.zeros((b, max_dec), dtype=np.int32)
    dec_seg = np.full((b, max_dec), -1, dtype=np.int32)
    out_lab = np.zeros((b, max_dec), dtype=np.int32)
    out_w = np.zeros((b, max_dec), dtype=np.float32)
    for r, row in enumerate(rows):
        ce = cd = 0
        for seg, sample_idx in enumerate(row):
            sl_e = int(lengths[sample_idx, 0])
            sl_d = int(lengths[sample_idx, 1])
            if sl_e <= 0 or sl_d <= 0:
                continue  # degenerate (e.g. dec-only) sample: nothing to pair
            le = min(sl_e, max_enc - ce)
            ld = min(sl_d, max_dec - cd)
            if le <= 0 or ld <= 0:
                break     # row budget exhausted
            t = tokens[sample_idx]
            enc_tok[r, ce : ce + le] = t[:le]
            enc_pos[r, ce : ce + le] = np.arange(le)
            enc_seg[r, ce : ce + le] = seg
            d = t[int(lengths[sample_idx, 0]):
                  int(lengths[sample_idx, 0]) + ld]
            dec_tok[r, cd : cd + ld] = d
            dec_pos[r, cd : cd + ld] = np.arange(ld)
            dec_seg[r, cd : cd + ld] = seg
            if ld > 1:
                out_lab[r, cd : cd + ld - 1] = d[1:]
                out_w[r, cd : cd + ld - 1] = 1.0
            ce += le
            cd += ld
    return {
        "enc_tokens": enc_tok,
        "enc_positions": enc_pos,
        "enc_segment_ids": enc_seg,
        "dec_tokens": dec_tok,
        "dec_positions": dec_pos,
        "dec_segment_ids": dec_seg,
        "labels": out_lab,
        "loss_weights": out_w,
    }


def materialize_packed_rows(rows, tokens: list[np.ndarray], max_len: int,
                            pad_id: int = 0):
    """Packing baseline materialization: multiple samples per row, segment
    ids mark boundaries (cross-contamination is prevented only if the
    attention implementation honours them — paper §2.2)."""
    b = len(rows)
    out_tok = np.full((b, max_len), pad_id, dtype=np.int32)
    out_lab = np.zeros((b, max_len), dtype=np.int32)
    out_w = np.zeros((b, max_len), dtype=np.float32)
    out_pos = np.zeros((b, max_len), dtype=np.int32)
    out_seg = np.full((b, max_len), -1, dtype=np.int32)
    for r, row in enumerate(rows):
        cur = 0
        for seg, sample_idx in enumerate(row.sample_indices):
            t = tokens[sample_idx]
            n = min(len(t), max_len - cur)
            if n <= 0:
                break
            out_tok[r, cur : cur + n] = t[:n]
            if n > 1:
                out_lab[r, cur : cur + n - 1] = t[1:n]
                out_w[r, cur : cur + n - 1] = 1.0
            out_pos[r, cur : cur + n] = np.arange(n)
            out_seg[r, cur : cur + n] = seg
            cur += n
    return {
        "tokens": out_tok,
        "labels": out_lab,
        "loss_weights": out_w,
        "positions": out_pos,
        "segment_ids": out_seg,
    }

"""The live-pair, byte and FLOP counts against brute force: masks built
element by element on tiny rows, and the plain reference's products
counted by ``torch.utils.flop_counter``."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, reference, weights
from portbench.tests.tiny import tiny_cell

M = {"family": "dense", "n_layers": 1, "n_heads": 2, "n_kv_heads": 1,
     "d_head": 4}


def _mask(q_seg, k_seg, q_pos, k_pos, causal):
    """(T, S) live pairs of one row, as the plain attention masks them."""
    m = (q_seg[:, None] == k_seg[None, :]) & (k_seg[None, :] >= 0)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    return m


def _packed_row(lengths, row_len):
    seg = np.full(row_len, -1)
    pos = np.zeros(row_len, dtype=np.int64)
    cur = 0
    for s, n in enumerate(lengths):
        seg[cur:cur + n] = s
        pos[cur:cur + n] = np.arange(n)
        cur += n
    return seg, pos


@pytest.mark.parametrize("rows", [[[5], [3], [1]], [[2, 3, 1], [4]],
                                  [[7, 1], [2, 2, 2, 2]]])
def test_decoder_pairs_and_bytes_equal_masks(rows):
    pairs = nq = nk = 0
    for row in rows:
        seg, pos = _packed_row(row, 8)
        m = _mask(seg, seg, pos, pos, True)
        pairs += int(m.sum())
        nq += int((m.any(axis=1)).sum())
        nk += int((m.any(axis=0)).sum())
    samples = [(n, 0) for row in rows for n in row]
    call = flops.attention_calls(M, samples)[0]
    assert call == (pairs, nq, nk)
    h, kv, d = 2, 1, 4
    want_fwd = max(4.0 * d * h * pairs / flops.PEAK_BF16_FLOPS,
                   (2 * nq * h * d * 2 + 2 * nk * kv * d * 2 + nq * h * 4
                    + (nq + nk) * 8) / flops.PEAK_HBM_BYTES)
    assert flops.fwd_bound_s(M, call) == pytest.approx(want_fwd)
    want_bwd = max(10.0 * d * h * pairs / flops.PEAK_BF16_FLOPS,
                   (3 * nq * h * d * 2 + 4 * nk * kv * d * 2 + 2 * nq * h * 4
                    + (nq + nk) * 8) / flops.PEAK_HBM_BYTES)
    assert flops.bwd_bound_s(M, call) == pytest.approx(want_bwd)


def test_encdec_pairs_equal_masks():
    m = {**M, "family": "encdec"}
    samples = [(5, 3), (2, 4)]
    eseg, epos = _packed_row([5, 2], 8)
    dseg, dpos = _packed_row([3, 4], 8)
    enc = _mask(eseg, eseg, epos, epos, False)
    dec = _mask(dseg, dseg, dpos, dpos, True)
    cross = _mask(dseg, eseg, dpos, epos, False)
    calls = flops.attention_calls(m, samples)
    assert calls[0] == (int(enc.sum()), 7, 7)
    assert calls[1] == (int(dec.sum()), 7, 7)
    assert calls[2] == (int(cross.sum()), 7, 7)


@pytest.mark.parametrize("name", ["gpt-paper-8l.dynamic",
                                  "t5-paper-4x4.dynamic"])
def test_model_flops_equal_the_references_products(name):
    """3 x the reference forward's weight products (aten.mm: projections,
    MLP, the head over the real vocabulary) plus 3 x 4 H D a live pair."""
    model = tiny_cell(name).model
    encdec = model["family"] == "encdec"
    rng = np.random.default_rng(0)
    lengths = [(9, 4), (5, 3)] if encdec else [(9, 0), (5, 0)]
    samples = [(rng.integers(0, model["vocab"], e),
                rng.integers(0, model["vocab"], d)) if encdec
               else rng.integers(0, model["vocab"], e) for e, d in lengths]
    params = {k: v.float() for k, v in weights.leaf_items(
        weights.make_params(model, 0, torch.device("cpu")))}
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        (reference.encdec_loss if encdec else reference.decoder_loss)(
            params, model, samples)
    mm = sum(n for op, n in counter.get_flop_counts()["Global"].items()
             if "mm" in str(op) and "bmm" not in str(op))
    pairs = sum(c[0] for c in flops.attention_calls(model, lengths))
    attn = 4 * model["n_heads"] * model["d_head"] * pairs
    assert flops.model_flops(model, lengths) == pytest.approx(
        3 * (mm + attn))

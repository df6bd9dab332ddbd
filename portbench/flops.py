"""Model FLOPs and the attention kernels' bounds, from sample lengths.

The peaks and the bound arithmetic are copied, frozen, from
``chip_smoke.py`` at commit 6c281531521ac131e36dd31e0d5322d0dc64508a
(``PEAK_BF16_FLOPS``, ``PEAK_HBM_BYTES``, ``_live_pairs``, ``_bound_ms``,
``_bwd_bound_ms``), restated over each real sample's own pairs instead of
a (B, T, S) mask: a causal sample of n tokens has n (n + 1) / 2 live
pairs, a bidirectional one n * n, a decoder sample's cross-attention
n_dec * n_enc. Padding computes nothing and is counted nowhere.

Model FLOPs count what the model needs, never what the program chose to
compute: 2 FLOPs a weight a token for every product (the head over the
real vocabulary), 4 * H * D a live pair for attention's two products, and
3 times the forward for forward and backward, with no recompute and no
padding.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def _proj_flops(m: dict) -> int:
    """Forward FLOPs of one token through one attention's q, k, v and o
    products."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    return 2 * d * dh * (2 * h + 2 * kv)


def _mlp_flops(m: dict) -> int:
    return 2 * 2 * m["d_model"] * m["d_ff"]


def model_flops(m: dict, lengths) -> float:
    """Forward and backward FLOPs of a global batch's real samples:
    ``lengths`` rows of (enc, dec) tokens (dec 0 for a decoder-only
    model)."""
    n, d, h, dh = m["n_layers"], m["d_model"], m["n_heads"], m["d_head"]
    pair = 4 * h * dh
    head = 2 * d * m["vocab"]
    layer = _proj_flops(m) + _mlp_flops(m)
    fwd = 0
    for e, dl in lengths:
        e, dl = int(e), int(dl)
        if m["family"] == "encdec":
            # encoder layers; decoder layers with their cross-attention:
            # q and o on decoder tokens, k and v on encoder tokens
            cross_q_o = 2 * 2 * d * h * dh
            cross_k_v = 2 * 2 * d * m["n_kv_heads"] * dh
            fwd += n * (e * layer + pair * e * e)
            fwd += n * (dl * (layer + cross_q_o) + e * cross_k_v
                        + pair * (causal_pairs(dl) + dl * e))
            fwd += dl * head
        else:
            fwd += n * (e * layer + pair * causal_pairs(e)) + e * head
    return 3.0 * fwd


def attention_calls(m: dict, samples) -> list:
    """One forward's attention calls on one micro-batch, each
    ``(live pairs, real queries, real keys)``: ``samples`` are the
    micro-batch's (enc, dec) lengths, whichever rows they share."""
    n = m["n_layers"]
    if m["family"] == "encdec":
        enc = (sum(e * e for e, _ in samples), sum(e for e, _ in samples),
               sum(e for e, _ in samples))
        dself = (sum(causal_pairs(d) for _, d in samples),
                 sum(d for _, d in samples), sum(d for _, d in samples))
        cross = (sum(d * e for e, d in samples), sum(d for _, d in samples),
                 sum(e for e, _ in samples))
        return [enc] * n + [dself, cross] * n
    one = (sum(causal_pairs(e) for e, _ in samples),
           sum(e for e, _ in samples), sum(e for e, _ in samples))
    return [one] * n


def fwd_bound_s(m: dict, call) -> float:
    """K1's least time for one call: the live pairs' FLOPs (q k^T and p v,
    2 x 2 x D each) over the bf16 peak, against the bytes of q, o, lse, the
    positions and segment ids of real tokens and k, v of real keys, each
    read or written once, over HBM."""
    pairs, nq, nk = call
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    flops = 4.0 * dh * h * pairs
    nbytes = (2 * nq * h * dh * 2         # q in, o out
              + 2 * nk * kv * dh * 2      # k and v of real keys
              + nq * h * 4                # lse out
              + (nq + nk) * 4 * 2)        # positions and segment ids
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def bwd_bound_s(m: dict, call) -> float:
    """The fused backward's least time for one call: 10 D FLOPs a live
    pair (s, dp, dv, dk, dq) over the bf16 peak, against q, do and dq of
    real queries, k, v, dk and dv of real keys, lse and delta and the int
    inputs, each once, over HBM."""
    pairs, nq, nk = call
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    flops = 10.0 * dh * h * pairs
    nbytes = (3 * nq * h * dh * 2         # q, do in; dq out
              + 4 * nk * kv * dh * 2      # k, v in; dk, dv out
              + 2 * nq * h * 4            # lse, delta
              + (nq + nk) * 4 * 2)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def roofline_pct(run, kernel: str, bound) -> float | None:
    """A kernel's share of its roofline in the traced cycle: the summed
    ``bound`` of one forward's attention calls on each traced micro-batch,
    times the passes the trace saw (the kernel's launches over those
    calls, recompute included), over the kernel's summed time; None where
    the trace saw no launch of it."""
    t = run.trace
    if t is None or kernel not in t.symbols:
        return None
    seconds, launches = t.symbols[kernel]
    calls = [c for mb in run.traced_mbs if mb
             for c in attention_calls(run.model, mb)]
    if not calls or seconds <= 0:
        return None
    passes = launches / len(calls)
    return 100.0 * passes * sum(bound(run.model, c) for c in calls) / seconds

"""Segment-aware (ragged / varlen) attention, forward only.

Counterpart of ``repro.kernels.ragged_attention``: per-token segment ids
mark sample boundaries inside a row, -1 marks padding. It binds the
segmented variant of the same kernel K1 (``csrc/flash_fwd.cu``), which
skips kv tiles whose segment-id range cannot meet the q tile's and masks
element-wise inside live tiles. The backward comes with the training port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    NEG_INF,            # noqa: F401  (re-exported for callers/tests)
    _default_positions,
    live_block_mask,    # noqa: F401  (segment-aware liveness, re-exported)
    mha_forward,
)


def ragged_attention(q, k, v, q_segment_ids, kv_segment_ids, *,
                     causal=True, window=0, softcap=None,
                     q_positions=None, kv_positions=None):
    """q (B,T,H,D), k/v (B,S,KV,D), segment ids (B,T)/(B,S) with -1 on
    padding -> (B,T,H,D) in q.dtype."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    assert k.shape == (b, s, kvh, d) and v.shape == (b, s, kvh, d)
    assert h % kvh == 0, (h, kvh)
    if q_positions is None:
        q_positions = _default_positions(q, t)
    if kv_positions is None:
        kv_positions = _default_positions(k, s)

    def i32(x):
        return x.to(torch.int32).contiguous()

    o, _ = mha_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                       i32(q_positions), i32(kv_positions),
                       i32(q_segment_ids), i32(kv_segment_ids),
                       causal=causal, window=int(window), softcap=softcap)
    return o

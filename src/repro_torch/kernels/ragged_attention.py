"""Segment-aware (ragged / varlen) attention, forward and backward.

Counterpart of ``repro.kernels.ragged_attention``: per-token segment ids
mark sample boundaries inside a row, -1 marks padding. It binds the
segmented variants of the kernels K1 (``csrc/flash_fwd.cu``), K2 and K3
(``csrc/flash_bwd.cu``), which skip tiles whose segment-id ranges cannot
meet and mask element-wise inside live tiles. The gradient goes through
``flash_attention.Attention``, the counterpart of the reference's
``_ragged`` custom VJP: the same Function as the plain path, given the
segment ids.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (
    NEG_INF,            # noqa: F401  (re-exported for callers/tests)
    attention,
    live_block_mask,    # noqa: F401  (segment-aware liveness, re-exported)
)


def ragged_attention(q, k, v, q_segment_ids, kv_segment_ids, *,
                     causal=True, window=0, softcap=None,
                     q_positions=None, kv_positions=None):
    """q (B,T,H,D), k/v (B,S,KV,D), segment ids (B,T)/(B,S) with -1 on
    padding -> (B,T,H,D) in q.dtype."""
    return attention(q, k, v, q_positions, kv_positions, q_segment_ids,
                     kv_segment_ids, causal=causal, window=window,
                     softcap=softcap)

"""Dispatch to the attention kernel by the device of the tensors.

Counterpart of ``repro.kernels.ops.attention``. There is no ``impl``
switch: a CUDA tensor always goes through the CUDA kernels (K1 forward; K2
and K3 for its gradient), a CPU tensor always through their plain versions.
:func:`launch_counts` reads how often each kernel was launched
(``mha_forward``, ``mha_backward_dq``, ``mha_backward_dkv``), so a run can
show that it went through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ragged_attention as _ra


def launch_counts() -> dict[str, int]:
    return dict(_fa.LAUNCHES)


def reset_launch_counts() -> None:
    for name in _fa.LAUNCHES:
        _fa.LAUNCHES[name] = 0


def attention(q, k, v, *, causal=True, window=0, softcap=None,
              q_positions=None, kv_positions=None,
              q_segment_ids=None, kv_segment_ids=None):
    """Multi-head attention; k/v carry KV heads (GQA, never repeated)."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        # one-sided segment ids (e.g. cross-attention with padded encoder
        # keys but no decoder segments): synthesize the missing side as one
        # all-zero segment so the mask applies
        if q_segment_ids is None:
            q_segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32,
                                        device=q.device)
        else:
            kv_segment_ids = torch.zeros(k.shape[:2], dtype=torch.int32,
                                         device=k.device)
    if q_segment_ids is not None:
        return _ra.ragged_attention(
            q, k, v, q_segment_ids, kv_segment_ids, causal=causal,
            window=window, softcap=softcap,
            q_positions=q_positions, kv_positions=kv_positions)
    return _fa.flash_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_positions=q_positions, kv_positions=kv_positions)

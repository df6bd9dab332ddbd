"""Dispatch to the attention and SSD kernels by the device of the tensors.

Counterpart of ``repro.kernels.ops``. There is no ``impl`` switch: a CUDA
tensor always goes through the CUDA kernels (K1 forward, one fused kernel
for its gradient in place of the reference's K2 and K3; K4 for the SSD), a
CPU tensor always through their plain versions. :func:`launch_counts` reads
how often each kernel was launched (``mha_forward``, ``mha_backward``,
``ssd_chunked``), so a run can show that it went through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ragged_attention as _ra
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd

_COUNTERS = (_fa.LAUNCHES, _ssd.LAUNCHES)


def launch_counts() -> dict[str, int]:
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


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


def ssd(x, dt, A, B, C, *, initial_state=None, return_state=False):
    """Mamba2 SSD over a full sequence. Returns y or ``(y, final_state)``.

    From a zero state a CUDA tensor launches K4 and a CPU tensor takes its
    plain version. An ``initial_state`` (which no caller of the reference
    passes) is taken on the CPU by the quadratic oracle, as the reference
    takes it by its ``ref`` path; on the card it raises."""
    if initial_state is not None:
        if x.device.type != "cpu":
            raise NotImplementedError(
                "K4 starts from a zero state; an initial state on the card "
                "is ROADMAP A17")
        return _ref.ssd_ref(x, dt, A, B, C, initial_state=initial_state,
                            return_state=return_state)
    y, state = _ssd.ssd_chunked(x, dt, A, B, C)
    return (y, state) if return_state else y


def ssd_decode(x, dt, A, B, C, state):
    """One step of the SSM recurrence (decode): plain PyTorch on every
    device, as the reference's is jnp and not a Pallas kernel."""
    return _ref.ssd_decode_ref(x, dt, A, B, C, state)

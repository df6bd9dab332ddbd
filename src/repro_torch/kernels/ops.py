"""Dispatch to the attention and SSD kernels by the device of the tensors.

Counterpart of ``repro.kernels.ops``. There is no ``impl`` switch: a CUDA
tensor always goes through the CUDA kernels (K1 forward, one fused kernel
for its gradient in place of the reference's K2 and K3; K4 for the SSD and
K4's backward for its gradient), a
CPU tensor always through their plain versions. :func:`launch_counts` reads
how often each kernel was launched (``mha_forward``, ``mha_backward``,
``ssd_chunked``, ``ssd_backward``), so a run can show that it went through
them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ragged_attention as _ra
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd

_COUNTERS = (_fa.LAUNCHES, _ssd.LAUNCHES)


def launch_counts() -> dict[str, int]:
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        _build.reset_counts(counts)


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


def attention_partial(q, k, v, *, causal=True, window=0, softcap=None,
                      q_positions, kv_positions):
    """K1's ``(o, lse)`` without a gradient: the attention of q over the
    keys given (one shard's slice of a KV cache), o in fp32 unrounded (on
    the card K1's decode form: T ≤ 16), and the
    log-sum-exp of each row's scores, lse (B, H, T) fp32; the -1e30
    sentinel and o zero on a row that sees no key.
    ``spmd.merge_attention`` merges the partials of the slices and rounds
    once."""
    def i32(x):
        return x.to(torch.int32).contiguous()
    return _fa.mha_partial(q.contiguous(), k.contiguous(), v.contiguous(),
                           i32(q_positions), i32(kv_positions), causal=causal,
                           window=int(window), softcap=softcap)


def ssd(x, dt, A, B, C, *, initial_state=None, return_state=False):
    """Mamba2 SSD over a full sequence. Returns y or ``(y, final_state)``.

    A CUDA tensor launches K4, from a zero state or from ``initial_state``,
    and where a gradient is needed K4's backward; a CPU tensor takes the
    plain version (from an initial state, which no caller of the reference
    passes, the quadratic oracle, as the reference takes its ``ref`` path
    there)."""
    y, state = _ssd.ssd_chunked(x, dt, A, B, C, initial_state=initial_state)
    return (y, state) if return_state else y


def ssd_decode(x, dt, A, B, C, state):
    """One step of the SSM recurrence (decode): plain PyTorch on every
    device, as the reference's is jnp and not a Pallas kernel."""
    return _ref.ssd_decode_ref(x, dt, A, B, C, state)

"""Plain PyTorch oracles for the attention kernel.

Counterparts of ``repro.kernels.ref.attention_ref`` and
``attention_ref_lse``: the whole (T, S) score matrix is materialised in
fp32. They are the ground truth the CUDA kernel is held against on the
card, and the path every CPU tensor takes.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*n_rep, D) by head repetition (GQA)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def attention_ref_with_lse(q, k, v, *, causal=True, window=0, softcap=None,
                           q_positions=None, kv_positions=None,
                           q_segment_ids=None, kv_segment_ids=None):
    """Materialised-scores attention. q (B,T,H,D), k/v (B,S,KV,D) ->
    ``(o, lse)``: o (B,T,H,D) in q.dtype, lse (B,H,T) fp32. A fully masked
    row gives o = 0 and lse = NEG_INF + log(1e-30), which is finite."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    assert h % kv == 0, (h, kv)
    if q_positions is None:
        q_positions = torch.arange(t, device=q.device)[None].expand(b, t)
    if kv_positions is None:
        kv_positions = torch.arange(s, device=q.device)[None].expand(b, s)

    scores = torch.einsum("bthd,bshd->bhts", q.float(),
                          _repeat_kv(k, h // kv).float())
    scores = scores / math.sqrt(d)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)

    mask = torch.ones((b, t, s), dtype=torch.bool, device=q.device)
    dpos = q_positions[:, :, None].long() - kv_positions[:, None, :].long()
    if causal:
        mask &= dpos >= 0
        if window > 0:
            mask &= dpos < window
    if q_segment_ids is not None and kv_segment_ids is not None:
        mask &= q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        mask &= kv_segment_ids[:, None, :] >= 0
        mask &= q_segment_ids[:, :, None] >= 0
    mask = mask[:, None, :, :]

    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    del scores
    l = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhts,bshd->bthd", e / l, _repeat_kv(v, h // kv).float())
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def attention_ref(q, k, v, **kw):
    """Materialised-scores attention, (B,T,H,D) in q.dtype."""
    return attention_ref_with_lse(q, k, v, **kw)[0]


def attention_ref_lse(q, k, **kw):
    """Masked per-row log-sum-exp of the logits, (B,H,T) fp32. It needs no
    v; k stands in for it and the output is dropped."""
    return attention_ref_with_lse(q, k, k, **kw)[1]

"""Plain PyTorch oracles for the attention and SSD kernels.

Counterparts of ``repro.kernels.ref.attention_ref`` and
``attention_ref_lse``, where the whole (T, S) score matrix is materialised
in fp32, and of the reference's SSD oracles ``ssd_ref``, ``ssd_ref_chunked``
and ``ssd_decode_ref``. They are the ground truth the CUDA kernels are held
against on the card, and the path every CPU tensor takes.
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


# ----------------------------------------------------------------------
# Mamba2 SSD (state-space duality)
# ----------------------------------------------------------------------
def _repeat_groups(x: torch.Tensor, rep: int, axis: int) -> torch.Tensor:
    """B or C at group ``h // rep`` for every head h, in fp32."""
    return torch.repeat_interleave(x.float(), rep, dim=axis)


def ssd_ref(x, dt, A, B, C, *, initial_state=None, return_state=False):
    """Quadratic SSD, the whole (T, T) decay matrix materialised: tests only.
    Counterpart of ``repro.kernels.ref.ssd_ref``.

    x (B,T,H,P), dt (B,T,H) > 0, A (H,) < 0, B/C (B,T,G,N); optional
    initial_state (B,H,P,N). Returns y (B,T,H,P) in x's dtype, and with
    ``return_state`` the final state (B,H,P,N) fp32."""
    b, t, h, p = x.shape
    g = B.shape[2]
    assert h % g == 0, (h, g)
    Bh = _repeat_groups(B, h // g, 2)                     # (B,T,H,N)
    Ch = _repeat_groups(C, h // g, 2)
    xf, dtf = x.float(), dt.float()
    acs = torch.cumsum(dtf * A[None, None, :], dim=1)     # (B,T,H)
    L = torch.exp(torch.clamp(acs[:, :, None, :] - acs[:, None, :, :],
                              -60.0, 0.0))                 # (B,T,S,H)
    tri = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri[None, :, :, None], L, 0.0)
    cb = torch.einsum("bthn,bshn->btsh", Ch, Bh)
    w = cb * L * dtf[:, None, :, :]
    y = torch.einsum("btsh,bshp->bthp", w, xf)
    state_decay = torch.exp(torch.clamp(acs, min=-60.0))
    if initial_state is not None:
        s0 = initial_state.float()
        y = y + torch.einsum("bthn,bhpn,bth->bthp", Ch, s0, state_decay)
    if not return_state:
        return y.to(x.dtype)
    dec_to_end = torch.exp(torch.clamp(acs[:, -1:, :] - acs, -60.0, 0.0))
    st = torch.einsum("bth,bthn,bthp->bhpn", dec_to_end * dtf, Bh, xf)
    if initial_state is not None:
        st = st + initial_state.float() * torch.exp(
            torch.clamp(acs[:, -1, :], min=-60.0))[:, :, None, None]
    return y.to(x.dtype), st


SSD_CHUNK = 128   # the reference kernel's chunk length


def ssd_ref_chunked(x, dt, A, B, C):
    """Chunked SSD: a loop over chunks of ``SSD_CHUNK`` steps carrying the
    (B,H,P,N) fp32 state, the algorithm of the TPU kernel and of K4.
    Returns ``(y, final_state)``. Counterpart of
    ``repro.kernels.ref.ssd_ref_chunked``, but any T works: x, dt, B and C
    are zero-filled past T in the last chunk, so its padded steps add no
    decay (dt·A = 0) and nothing to the state (dt·B x = 0), and y is cut
    back to T. It is K4's plain version."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert h % g == 0, (h, g)
    nc = -(-t // SSD_CHUNK)
    pad = nc * SSD_CHUNK - t

    def chunks(v):   # (B, T, ...) -> (B, nc, SSD_CHUNK, ...), zero-filled
        v = torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
        return v.reshape(b, nc, SSD_CHUNK, *v.shape[2:])

    xs = chunks(x.float())
    dts = chunks(dt.float())
    Bs = chunks(_repeat_groups(B, h // g, 2))
    Cs = chunks(_repeat_groups(C, h // g, 2))
    tri = torch.ones((SSD_CHUNK, SSD_CHUNK), dtype=torch.bool,
                     device=x.device).tril()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xs[:, c], dts[:, c], Bs[:, c], Cs[:, c]
        cum = torch.cumsum(dtc * A[None, None, :], dim=1)        # (B,bt,H)
        seg = torch.clamp(cum[:, :, None, :] - cum[:, None, :, :], -60.0, 0.0)
        Lm = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("bthn,bshn->btsh", Cc, Bc)
        w = cb * Lm * dtc[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", w, xc)
        cdec = Cc * torch.exp(torch.clamp(cum, min=-60.0))[..., None]
        y = y + torch.einsum("bthn,bhpn->bthp", cdec, state)
        a_tot = cum[:, -1:, :]
        dec_end = torch.exp(torch.clamp(a_tot - cum, -60.0, 0.0)) * dtc
        upd = torch.einsum("bth,bthn,bthp->bhpn", dec_end, Bc, xc)
        state = state * torch.exp(torch.clamp(
            a_tot[:, 0, :], min=-60.0))[:, :, None, None] + upd
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t].to(x.dtype), state


def ssd_decode_ref(x, dt, A, B, C, state):
    """One step of the SSM recurrence (decode). x (B,H,P), dt (B,H),
    B/C (B,G,N), state (B,H,P,N). Returns ``(y (B,H,P) in x's dtype,
    new state in state's dtype)``. Counterpart of
    ``repro.kernels.ref.ssd_decode_ref``: no clip, as there."""
    h, g = x.shape[1], B.shape[1]
    Bh = _repeat_groups(B, h // g, 1)                     # (B,H,N)
    Ch = _repeat_groups(C, h // g, 1)
    dtf = dt.float()
    decay = torch.exp(dtf * A[None, :])                   # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dtf, Bh, x.float())
    new_state = state.float() * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    return y.to(x.dtype), new_state.to(state.dtype)

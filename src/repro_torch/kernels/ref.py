"""Plain PyTorch oracles for the attention and SSD kernels.

Counterparts of ``repro.kernels.ref.attention_ref`` and
``attention_ref_lse``, where the whole (T, S) score matrix is materialised
in fp32, and of the reference's SSD oracles ``ssd_ref``, ``ssd_ref_chunked``
and ``ssd_decode_ref``. They are the ground truth the CUDA kernels are held
against on the card, and the path every CPU tensor takes. Beside them,
:func:`ssd_chunk_parallel` is the plain form of K4's own passes (chunk
states, the pass over chunks, y), which lets a check on the card tell a
fault in one pass from a fault in another; :func:`ssd_chunked_bwd` is
K4's gradient as one plain reverse walk over chunks, and
:func:`ssd_chunked_bwd_parallel` the same function in the two passes that
K4's backward takes (:func:`ssd_bwd_dstates`, then :func:`ssd_bwd_chunks`).
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


def _chunked(v, nc, chunk):
    """(B, T, ...) -> (B, nc, chunk, ...), zero-filled past T."""
    pad = nc * chunk - v.shape[1]
    v = torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
    return v.reshape(v.shape[0], nc, chunk, *v.shape[2:])


def ssd_chunk_states(x, dt, A, B, chunk=64):
    """The first pass of K4's chunk-parallel form: every chunk's own state
    from a zero start, ``Sk = xᵀ (B ∘ e^{clip(a_tot - cum, -60, 0)} dt)``
    (B, nc, H, P, N) fp32, and its total log decay ``a_tot`` (B, nc, H);
    x, dt and B zero-filled past T as in :func:`ssd_ref_chunked`."""
    b, t, h, p = x.shape
    g = B.shape[2]
    nc = -(-t // chunk)
    xs = _chunked(x.float(), nc, chunk)                   # (B,nc,L,H,P)
    dts = _chunked(dt.float(), nc, chunk)                 # (B,nc,L,H)
    Bs = _chunked(_repeat_groups(B, h // g, 2), nc, chunk)
    cum = torch.cumsum(dts * A[None, None, None, :], dim=2)
    a_tot = cum[:, :, -1]
    dec_end = torch.exp(torch.clamp(a_tot[:, :, None] - cum, -60.0, 0.0)) * dts
    return torch.einsum("bclh,bclhn,bclhp->bchpn", dec_end, Bs, xs), a_tot


def ssd_state_pass(chunk_states, a_tot, initial_state=None):
    """The pass over chunks: S <- e^{max(a_tot, -60)} S + Sk from a zero
    state, or from ``initial_state`` (B, H, P, N). Returns ``(starts,
    final)``: the state at the start of every chunk after the first, (B, H,
    nc - 1, P, N) as K4 writes them when asked (there as bf16 hi and lo
    parts), and the final state (B, H, P, N), both fp32."""
    s = (torch.zeros_like(chunk_states[:, 0]) if initial_state is None
         else initial_state.float())
    starts = []
    for c in range(chunk_states.shape[1]):
        if c:
            starts.append(s)
        s = s * torch.exp(torch.clamp(a_tot[:, c], min=-60.0))[
            :, :, None, None] + chunk_states[:, c]
    b, _, h, p, n = chunk_states.shape
    return (torch.stack(starts, dim=2) if starts
            else s.new_zeros((b, h, 0, p, n))), s


def ssd_chunk_y(x, dt, A, B, C, starts, chunk=64, initial_state=None):
    """The y pass: per chunk, ``((C Bᵀ) ∘ L ∘ dt) x + e^{max(cum, -60)} ∘
    (C Sᵀ)`` with S the chunk's start state from :func:`ssd_state_pass`
    (for the first chunk ``initial_state``, or zero). Returns y (B, T, H,
    P) in x's dtype."""
    b, t, h, p = x.shape
    g = B.shape[2]
    nc = -(-t // chunk)
    xs = _chunked(x.float(), nc, chunk)
    dts = _chunked(dt.float(), nc, chunk)
    Bs = _chunked(_repeat_groups(B, h // g, 2), nc, chunk)
    Cs = _chunked(_repeat_groups(C, h // g, 2), nc, chunk)
    cum = torch.cumsum(dts * A[None, None, None, :], dim=2)    # (B,nc,L,H)
    seg = torch.clamp(cum[:, :, :, None] - cum[:, :, None], -60.0, 0.0)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    w = torch.einsum("bcihn,bcjhn->bcijh", Cs, Bs) * torch.where(
        tri[None, None, :, :, None], torch.exp(seg), 0.0) * dts[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xs)
    first = (starts.new_zeros((b, h) + starts.shape[3:]) if initial_state
             is None else initial_state)
    prev = torch.cat([first[:, :, None].float(), starts.float()],
                     dim=2)                                # (B,H,nc,P,N)
    y = y + torch.einsum("bcihn,bhcpn,bcih->bcihp", Cs, prev,
                         torch.exp(torch.clamp(cum, min=-60.0)))
    return y.reshape(b, nc * chunk, h, p)[:, :t].to(x.dtype)


def ssd_chunk_parallel(x, dt, A, B, C, chunk=64, initial_state=None):
    """K4's chunk-parallel form in plain PyTorch, pass by pass: the chunk
    states, the pass over chunks, then y, from a zero state or from
    ``initial_state``. Returns ``(y, final_state, starts)``, starts as
    :func:`ssd_state_pass` gives them, so that each of K4's passes can be
    held to its own plain version."""
    chunk_states, a_tot = ssd_chunk_states(x, dt, A, B, chunk)
    starts, final = ssd_state_pass(chunk_states, a_tot, initial_state)
    return (ssd_chunk_y(x, dt, A, B, C, starts, chunk, initial_state), final,
            starts)


def ssd_chunked_bwd(x, dt, A, B, C, dy, starts, d_final=None,
                    initial_state=None, chunk=64):
    """K4's backward in plain PyTorch: the reverse walk over ``chunk``-step
    chunks that its kernel (``csrc/ssd_bwd.cu``) takes, carrying dS, the
    gradient of the state at a chunk's end, from ``d_final`` (B, H, P, N),
    or zero, back to the first chunk. ``starts`` are the states at the
    start of every chunk after the first, as :func:`ssd_chunk_parallel`
    gives them; the first chunk starts from ``initial_state``, or zero.
    Returns ``(dx, ddt, dA, dB, dC, d_initial)``: dx in x's dtype, dB and
    dC in B's dtype (summed over the heads of a group), ddt, dA and
    d_initial (the gradient of the initial state) in fp32.

    Per chunk, with a = dt·A, cum its in-chunk prefix sum, a_tot its last
    value, L_ts = e^{clip(cum_t - cum_s, -60, 0)} (s <= t), E_t =
    e^{max(cum_t, -60)}, u_s = e^{clip(a_tot - cum_s, -60, 0)} dt_s, S the
    chunk's start state and dS' the carried gradient:

    - dS = e^{max(a_tot, -60)} dS' + Σ_t E_t dy_t C_tᵀ, carried back;
    - dx = Wᵀ dy + u ∘ (B dS'ᵀ), W_ts = (C_t·B_s) L_ts dt_s;
    - dC = M B + E ∘ (dy S), M_ts = (dy_t·x_s) L_ts dt_s;
    - dB = Mᵀ C + u ∘ (x dS');
    - ddt_s = Σ_t (C_t·B_s)(dy_t·x_s) L_ts + e^{clip(a_tot - cum_s)}
      x_sᵀ dS' B_s, then + A da_s; dA = Σ dt da;
    - da_r = Σ_{t >= r} dcum_t, where with G_ts = (C_t·B_s)(dy_t·x_s) L_ts
      dt_s and V_s = u_s x_sᵀ dS' B_s: dcum_t = Σ_s G_ts - Σ_t' G_t't +
      E_t dy_t·(S C_t) - V_t, and the last step gains Σ_s V_s +
      e^{a_tot} <dS', S>. Each term holds only where its clip does not
      bite (the gradient of torch.clamp and of the reference's jnp.clip
      is zero there).
    """
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = -(-t // chunk)
    xs = _chunked(x.float(), nc, chunk)                   # (B,nc,L,H,P)
    dys = _chunked(dy.float(), nc, chunk)
    dts = _chunked(dt.float(), nc, chunk)                 # (B,nc,L,H)
    Bs = _chunked(_repeat_groups(B, rep, 2), nc, chunk)   # (B,nc,L,H,N)
    Cs = _chunked(_repeat_groups(C, rep, 2), nc, chunk)
    Af = A.float()
    cum = torch.cumsum(dts * Af, dim=2)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    s0 = (x.new_zeros((b, h, p, n), dtype=torch.float32)
          if initial_state is None else initial_state.float())
    S_all = torch.cat([s0[:, :, None], starts.float()], dim=2)  # (B,H,nc,P,N)
    dS = (x.new_zeros((b, h, p, n), dtype=torch.float32) if d_final is None
          else d_final.float())
    dxs, ddts, dBs, dCs = [], [], [], []
    dA = torch.zeros_like(Af)
    for c in reversed(range(nc)):
        xc, dyc, dtc = xs[:, c], dys[:, c], dts[:, c]
        Bc, Cc, cm = Bs[:, c], Cs[:, c], cum[:, c]
        S = S_all[:, :, c]
        a_tot = cm[:, -1]                                  # (B,H)
        diff = cm[:, :, None] - cm[:, None, :]             # (B,t,s,H)
        Lm = torch.where(tri, torch.exp(torch.clamp(diff, -60.0, 0.0)), 0.0)
        live = tri & (diff >= -60.0)
        E = torch.exp(torch.clamp(cm, min=-60.0))          # (B,L,H)
        eu = torch.exp(torch.clamp(a_tot[:, None] - cm, -60.0, 0.0))
        u = eu * dtc
        decay = torch.exp(torch.clamp(a_tot, min=-60.0))
        CB = torch.einsum("bthn,bshn->btsh", Cc, Bc)
        DX = torch.einsum("bthp,bshp->btsh", dyc, xc)
        W = CB * Lm * dtc[:, None]
        M = DX * Lm * dtc[:, None]
        q = torch.einsum("bhpn,bshn->bshp", dS, Bc)        # dS' B_s
        dxs.append(torch.einsum("btsh,bthp->bshp", W, dyc) + u[..., None] * q)
        SdY = torch.einsum("bthp,bhpn->bthn", dyc, S)      # Sᵀ dy_t
        dCs.append(torch.einsum("btsh,bshn->bthn", M, Bc) + E[..., None] * SdY)
        dBs.append(torch.einsum("btsh,bthn->bshn", M, Cc) + u[..., None]
                   * torch.einsum("bshp,bhpn->bshn", xc, dS))
        cbdx = CB * DX * Lm
        G = torch.where(live, cbdx * dtc[:, None], 0.0)
        xq = (xc * q).sum(-1)                               # x_sᵀ dS' B_s
        V = torch.where(a_tot[:, None] - cm >= -60.0, u * xq, 0.0)
        ecs = torch.where(cm >= -60.0, E * (Cc * SdY).sum(-1), 0.0)
        dcum = G.sum(2) - G.sum(1) + ecs - V
        dcum[:, -1] += V.sum(1) + torch.where(
            a_tot >= -60.0, decay * (dS * S).sum((-2, -1)), 0.0)
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddts.append(cbdx.sum(1) + eu * xq + Af * da)
        dA = dA + (dtc * da).sum((0, 1))
        dS = decay[..., None, None] * dS + torch.einsum(
            "bth,bthp,bthn->bhpn", E, dyc, Cc)

    def whole(parts):   # chunks in reverse order -> (B, T, ...)
        return torch.cat(parts[::-1], dim=1)[:, :t]

    def by_group(v):    # (B, T, H, N) -> summed over each group's heads
        return v.reshape(b, t, g, rep, n).sum(3).to(B.dtype)
    return (whole(dxs).to(x.dtype), whole(ddts), dA, by_group(whole(dBs)),
            by_group(whole(dCs)), dS)


def _chunk_decays(dt, A, nc, chunk):
    """Per chunk of ``chunk`` steps (dt zero-filled past T): dt (B, nc, L,
    H), cum its in-chunk prefix sum of dt·A, and a_tot its last value."""
    dts = _chunked(dt.float(), nc, chunk)
    cum = torch.cumsum(dts * A.float(), dim=2)
    return dts, cum, cum[:, :, -1]


def ssd_bwd_dstates(dt, A, C, dy, d_final=None, chunk=64):
    """The first pass of K4's backward: the gradient of every chunk's end
    state, carried back over the chunks, dS'_{c-1} = e^{max(a_tot_c, -60)}
    dS'_c + (E_c ∘ dy_c)ᵀ C_c with E_t = e^{max(cum_t, -60)}, from
    ``d_final`` (B, H, P, N), or zero, at the last chunk. Returns
    ``(dstates, d_initial)``: dS' of every chunk (B, H, nc, P, N), as the
    kernel writes them (there as bf16 hi and lo parts), and the gradient of
    the first chunk's start state (B, H, P, N), both fp32."""
    b, t, h, p = dy.shape
    g, n = C.shape[2], C.shape[3]
    nc = -(-t // chunk)
    _, cum, a_tot = _chunk_decays(dt, A, nc, chunk)
    dys = _chunked(dy.float(), nc, chunk)                 # (B,nc,L,H,P)
    Cs = _chunked(_repeat_groups(C, h // g, 2), nc, chunk)
    E = torch.exp(torch.clamp(cum, min=-60.0))
    local = torch.einsum("bclh,bclhp,bclhn->bchpn", E, dys, Cs)
    decay = torch.exp(torch.clamp(a_tot, min=-60.0))      # (B,nc,H)
    ds = (dy.new_zeros((b, h, p, n), dtype=torch.float32) if d_final is None
          else d_final.float())
    out = []
    for c in reversed(range(nc)):
        out.append(ds)
        ds = decay[:, c, :, None, None] * ds + local[:, c]
    return torch.stack(out[::-1], dim=2), ds


def ssd_bwd_chunks(x, dt, A, B, C, dy, starts, dstates, initial_state=None,
                   chunk=64):
    """The second pass of K4's backward, every chunk at once: from each
    chunk's start state S (``starts`` as :func:`ssd_chunk_parallel` gives
    them, the first chunk from ``initial_state`` or zero) and the gradient
    of its end state dS' (``dstates`` from :func:`ssd_bwd_dstates`), the
    gradients ``(dx, ddt, dA, dB, dC)``, the terms of :func:`ssd_chunked_bwd` computed chunk-parallel:
    dx in x's dtype, dB and dC in B's (summed over a group's heads), ddt
    and dA (summed over batch rows and chunks) in fp32."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = -(-t // chunk)
    xs = _chunked(x.float(), nc, chunk)                   # (B,nc,L,H,P)
    dys = _chunked(dy.float(), nc, chunk)
    Bs = _chunked(_repeat_groups(B, rep, 2), nc, chunk)   # (B,nc,L,H,N)
    Cs = _chunked(_repeat_groups(C, rep, 2), nc, chunk)
    dts, cum, a_tot = _chunk_decays(dt, A, nc, chunk)     # (B,nc,L,H)
    zeros = x.new_zeros((b, h, 1, p, n), dtype=torch.float32)
    S = torch.cat([zeros if initial_state is None
                   else initial_state.float()[:, :, None], starts.float()],
                  dim=2).transpose(1, 2)                  # (B,nc,H,P,N)
    dS = dstates.float().transpose(1, 2)                  # (B,nc,H,P,N)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None] - cum[:, :, None]           # (B,nc,t,s,H)
    Lm = torch.where(tri, torch.exp(torch.clamp(diff, -60.0, 0.0)), 0.0)
    live = tri & (diff >= -60.0)
    E = torch.exp(torch.clamp(cum, min=-60.0))
    eu = torch.exp(torch.clamp(a_tot[:, :, None] - cum, -60.0, 0.0))
    u = eu * dts
    decay = torch.exp(torch.clamp(a_tot, min=-60.0))      # (B,nc,H)
    CB = torch.einsum("bcthn,bcshn->bctsh", Cs, Bs)
    DX = torch.einsum("bcthp,bcshp->bctsh", dys, xs)
    W = CB * Lm * dts[:, :, None]
    M = DX * Lm * dts[:, :, None]
    q = torch.einsum("bchpn,bcshn->bcshp", dS, Bs)         # dS' B_s
    dx = torch.einsum("bctsh,bcthp->bcshp", W, dys) + u[..., None] * q
    SdY = torch.einsum("bcthp,bchpn->bcthn", dys, S)      # Sᵀ dy_t
    dC = torch.einsum("bctsh,bcshn->bcthn", M, Bs) + E[..., None] * SdY
    dB = torch.einsum("bctsh,bcthn->bcshn", M, Cs) + u[..., None] \
        * torch.einsum("bcshp,bchpn->bcshn", xs, dS)
    cbdx = CB * DX * Lm
    G = torch.where(live, cbdx * dts[:, :, None], 0.0)
    xq = (xs * q).sum(-1)                                  # x_sᵀ dS' B_s
    V = torch.where(a_tot[:, :, None] - cum >= -60.0, u * xq, 0.0)
    ecs = torch.where(cum >= -60.0, E * (Cs * SdY).sum(-1), 0.0)
    dcum = G.sum(3) - G.sum(2) + ecs - V
    dcum[:, :, -1] += V.sum(2) + torch.where(
        a_tot >= -60.0, decay * (dS * S).sum((-2, -1)), 0.0)
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = cbdx.sum(2) + eu * xq + A.float() * da
    dA = (dts * da).sum((0, 1, 2))

    def whole(v):       # (B, nc, L, ...) -> (B, T, ...)
        return v.reshape(b, nc * chunk, *v.shape[3:])[:, :t]

    def by_group(v):    # (B, T, H, N) -> each group's heads summed in
        v = v.reshape(b, t, g, rep, n)     # ascending order, as the kernel
        acc = v[:, :, :, 0]
        for r in range(1, rep):
            acc = acc + v[:, :, :, r]
        return acc.to(B.dtype)
    return (whole(dx).to(x.dtype), whole(ddt), dA, by_group(whole(dB)),
            by_group(whole(dC)))


def ssd_chunked_bwd_parallel(x, dt, A, B, C, dy, starts, d_final=None,
                             initial_state=None, chunk=64):
    """K4's backward in plain PyTorch as its kernel decomposes it: the same
    arguments and outputs as :func:`ssd_chunked_bwd`. First the pass over
    chunks that carries only dS' (:func:`ssd_bwd_dstates`), then every
    chunk at once from its start state and its dS', a group's heads summed
    in ascending order (:func:`ssd_bwd_chunks`)."""
    dstates, d_initial = ssd_bwd_dstates(dt, A, C, dy, d_final, chunk)
    return ssd_bwd_chunks(x, dt, A, B, C, dy, starts, dstates,
                          initial_state, chunk) + (d_initial,)


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

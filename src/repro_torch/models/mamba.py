"""Mamba2 (SSD) mixer block in PyTorch: mamba2-130m's only mixer.

Counterpart of ``repro.models.mamba`` over the same parameter dict (same
keys, shapes, scales and dtypes): fused in_proj -> [z | x | B | C | dt],
causal depthwise conv over [x | B | C], softplus(dt + bias), the SSD core
(K4 on the card through ``kernels.ops.ssd``), per-head D skip, gated
RMSNorm, out_proj. Decode keeps (conv_state, ssm_state) and costs O(1) per
token; the SSD step of decode is plain PyTorch, as the reference's is jnp.
On tensors a block runs on one device. Inside a shard group
(``dist/spmd.py``) :func:`mamba_fwd_spmd` runs each shard's program, as
GSPMD partitions the reference's: where the SSD heads divide the model
axis (``_tp_ok``), each shard runs K4 and its backward on its own heads;
where they do not, every model shard runs the whole mixer on its data
shard's rows with the weights gathered. In prefill and decode it takes
the conv and ssm caches laid out by ``train_state.cache_spec_tree``
(channels and heads over tp), each shard writing its chunk.
``mamba_logical`` is the reference's. Caches are written in place, as the
KV cache is.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist import spmd
from repro_torch.dist.sharding import axis_map, axis_size, shard
from repro_torch.dist.spmd import Sharded
from repro_torch.kernels import ops
from repro_torch.models.layers import (_col, _dtype, _init, _row,
                                       _to_residual, rms_norm)


def _tp_ok(cfg: ArchConfig) -> bool:
    """Whether the SSD head count divides the ambient mesh's model axis
    (the reference shards Mamba internals only then)."""
    tp = axis_size("tp")
    return tp == 1 or cfg.ssm_heads % tp == 0


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    g, n, hh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    return di, g, n, hh, conv_ch


def init_mamba(gen: torch.Generator, cfg: ArchConfig, device="cuda"):
    """Random mixer params with the reference's shapes, scales and dtypes
    (``A_log``, ``dt_bias`` and ``D`` fp32; A = -exp(0) = -1)."""
    device = resolve_device(device)
    d = cfg.d_model
    di, g, n, hh, conv_ch = _dims(cfg)
    dt = _dtype(cfg)
    proj_out = 2 * di + 2 * g * n + hh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _init(gen, (d, proj_out), d ** -0.5, dt, device),
        "conv_w": _init(gen, (cfg.ssm_conv, conv_ch), 0.3, dt, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.zeros((hh,), **f32),
        "dt_bias": torch.zeros((hh,), **f32),
        "D": torch.ones((hh,), **f32),
        "norm_w": torch.zeros((di,), dtype=dt, device=device),
        "out_proj": _init(gen, (di, d), di ** -0.5, dt, device),
    }


def mamba_logical(cfg: ArchConfig):
    return {
        "in_proj": (None, "tp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "A_log": (None,),
        "dt_bias": (None,),
        "D": (None,),
        "norm_w": ("tp",),
        "out_proj": ("tp", None),
    }


def _split_proj(zxbcdt, cfg: ArchConfig):
    di, g, n, hh, _ = _dims(cfg)
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di : 2 * di]
    bc = zxbcdt[..., 2 * di : 2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n :]
    return z, xin, bc, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: u (B,T,C), w (K,C) -> (B,T,C), in fp32 as K
    shifted multiply-adds (``F.conv1d`` would take cuDNN's TF32 on the
    card, where the reference convolves in fp32)."""
    k = w.shape[0]
    t = u.shape[1]
    uf = F.pad(u.float(), (0, 0, k - 1, 0))        # k - 1 zero steps first
    wf = w.float()
    out = uf[:, 0:t] * wf[0]
    for i in range(1, k):
        out = out + uf[:, i:i + t] * wf[i]
    return (out + b.float()).to(u.dtype)


def mamba_fwd(
    p,
    x: torch.Tensor,                      # (B, T, D)
    cfg: ArchConfig,
    *,
    cache: Optional[dict] = None,         # {"conv": (B,K-1,C), "ssm": (B,H,P,N)}
    mode: str = "train",                  # train | prefill | decode
):
    """Returns ``(out (B,T,D), cache)``. In prefill and decode the cache
    tensors are written in place (the reference returns new arrays) and
    returned; train takes and returns None."""
    b, t, _ = x.shape
    di, g, n, hh, conv_ch = _dims(cfg)
    hd = cfg.ssm_headdim

    zxbcdt = x @ p["in_proj"]
    z, xin, bc, dtp = _split_proj(zxbcdt, cfg)
    u = torch.cat([xin, bc], dim=-1)                # (B,T,conv_ch)

    if mode == "decode":
        win = torch.cat([cache["conv"], u], dim=1)  # (B,K,C)
        conv = torch.einsum("bkc,kc->bc", win.float(), p["conv_w"].float())
        conv = (conv + p["conv_b"].float())[:, None, :].to(x.dtype)
        cache["conv"].copy_(win[:, 1:, :])
    else:
        conv = _causal_conv(u, p["conv_w"], p["conv_b"])
        if mode == "prefill":
            k = cfg.ssm_conv
            pad = torch.zeros((b, k - 1, conv_ch), dtype=u.dtype,
                              device=u.device)
            cache["conv"].copy_(torch.cat([pad, u], dim=1)[:, -(k - 1):, :])
    conv = F.silu(conv.float()).to(x.dtype)

    xc = conv[..., :di]
    bcc = conv[..., di:]
    Bc = bcc[..., : g * n].reshape(b, -1, g, n)     # views of conv: K4
    Cc = bcc[..., g * n :].reshape(b, -1, g, n)     # reads their strides
    dt = F.softplus(dtp.float() + p["dt_bias"])     # (B,T,H)
    A = -torch.exp(p["A_log"])                      # (H,)

    if mode == "decode":
        xh = xc.reshape(b, hh, hd)
        y, new_ssm = ops.ssd_decode(xh, dt[:, 0], A, Bc[:, 0], Cc[:, 0],
                                    cache["ssm"])
        cache["ssm"].copy_(new_ssm)
        y = y + p["D"][None, :, None] * xh.float()
        y = y.reshape(b, 1, di).to(x.dtype)
    else:
        xh = xc.reshape(b, t, hh, hd)
        if mode == "prefill":
            y, st = ops.ssd(xh, dt, A, Bc, Cc, return_state=True)
            cache["ssm"].copy_(st)
        else:
            y = ops.ssd(xh, dt, A, Bc, Cc)
        y = y + (p["D"][None, None, :, None] * xh.float()).to(y.dtype)
        y = y.reshape(b, -1, di)

    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y.float() * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], cache


# ----------------------------------------------------------------------
# inside a shard group: each shard's program
# ----------------------------------------------------------------------
def mamba_fwd_spmd(p, x: Sharded, cfg: ArchConfig, *,
                   cache: Optional[dict] = None,
                   mode: str = "train") -> Sharded:
    """The mixer inside a shard group, ``x`` (B, T, D) and the output in
    the residual's layout; in prefill and decode ``cache`` holds
    :class:`Sharded` conv and ssm leaves laid out by
    ``train_state.cache_spec_tree`` (the conv channels and the ssm heads
    over tp where they divide), written in place.

    Where the model axis (n ranks) divides the SSD heads, shard m takes
    heads [m·H/n, (m + 1)·H/n): in_proj column-parallel over its local
    columns, the projection then gathered whole (its columns are split
    where they fall, not at the z | x | B | C | dt boundaries) and each
    shard cutting its z, x and dt and the whole B and C; the conv over
    its x channels and B | C, with conv_w and conv_b gathered; K4 on its
    heads (in prefill from a zero state, its final state written into the
    shard's heads of the ssm cache); the gated RMSNorm's sum of squares
    over d_inner summed over the model axis (fp32, ascending rank);
    out_proj row-parallel, its partial output reduce-scattered onto the
    residual's layout. B and C feed every shard's K4, so each shard's
    backward gives a partial dB and dC, summed by the gather's transpose
    (a reduce-scatter in ascending rank). The conv cache's chunks of
    conv_ch follow no x | B | C boundary either: in prefill each shard
    takes the window of the last K - 1 steps from its gathered projection
    and keeps its chunk; in decode the chunks are gathered (B x (K - 1) x
    conv_ch, small), each shard convolves its channels over the window,
    steps its heads' state (``ops.ssd_decode``) and keeps its chunk of
    the shifted window. Where the axis does not divide the heads, or there
    is none, every shard runs :func:`mamba_fwd` on the sequence and the
    weights gathered, on the whole conv cache (gathered where split, its
    chunk kept) and its ssm cache, which stays whole: its output is a copy
    on every model shard, cut to the residual's layout, in no sum over
    that axis."""
    g = x.group
    tp_axes = tuple(axis_map().get("tp", ()))
    n = axis_size("tp")
    xg = shard(x, "dp", None, None)
    if n == 1 or not _tp_ok(cfg):
        return shard(_mamba_whole_spmd(p, xg, cfg, cache, mode),
                     "dp", "sp", None)
    di, ng, ns, hh, _ = _dims(cfg)
    hd = cfg.ssm_headdim
    hl, dl = hh // n, di // n
    gn = ng * ns
    k = cfg.ssm_conv
    proj = _col(xg, p["in_proj"])
    proj = spmd.redistribute(proj, (proj.spec[0], (), ()))
    conv_w, conv_b = (spmd.gather_whole(p[k_]) for k_ in ("conv_w", "conv_b"))
    if mode == "decode":
        conv_c = cache["conv"]
        window = spmd.redistribute(conv_c, (conv_c.spec[0], (), ()))

    def mixer(r):
        m = g.chunk(r, tp_axes)[0]
        zx = proj.locals[r]
        b, t, _ = zx.shape
        z = zx[..., m * dl:(m + 1) * dl]
        u = zx[..., di:2 * di + 2 * gn]              # x | B | C, all channels
        d0 = 2 * di + 2 * gn + m * hl
        dtp = zx[..., d0:d0 + hl]
        cw, cb = conv_w.locals[r], conv_b.locals[r]
        cw = torch.cat([cw[:, m * dl:(m + 1) * dl], cw[:, di:]], dim=-1)
        cb = torch.cat([cb[m * dl:(m + 1) * dl], cb[di:]])
        u_mine = torch.cat([u[..., m * dl:(m + 1) * dl], u[..., di:]],
                           dim=-1)
        if mode == "decode":
            win = torch.cat([window.locals[r], u], dim=1)    # (B, K, C)
            win_mine = torch.cat([win[..., m * dl:(m + 1) * dl],
                                  win[..., di:]], dim=-1)
            conv = torch.einsum("bkc,kc->bc", win_mine.float(), cw.float())
            conv = (conv + cb.float())[:, None, :].to(zx.dtype)
            cache["conv"].locals[r].copy_(
                spmd.own_chunk(cache["conv"], r, win[:, 1:, :]))
        else:
            conv = _causal_conv(u_mine, cw, cb)
            if mode == "prefill":
                pad = u.new_zeros((b, k - 1, u.shape[-1]))
                last = torch.cat([pad, u], dim=1)[:, -(k - 1):, :]
                cache["conv"].locals[r].copy_(
                    spmd.own_chunk(cache["conv"], r, last))
        conv = F.silu(conv.float()).to(zx.dtype)
        xc = conv[..., :dl]
        Bc = conv[..., dl:dl + gn].reshape(b, t, ng, ns)
        Cc = conv[..., dl + gn:].reshape(b, t, ng, ns)
        heads = slice(m * hl, (m + 1) * hl)
        # dt_bias, A_log and D are whole on every shard (mamba_logical)
        dt = F.softplus(dtp.float() + p["dt_bias"].locals[r][heads])
        A = -torch.exp(p["A_log"].locals[r][heads])
        D = p["D"].locals[r][heads]
        if mode == "decode":
            ssm = cache["ssm"].locals[r]
            xh = xc.reshape(b, hl, hd)
            y, new_ssm = ops.ssd_decode(xh, dt[:, 0], A, Bc[:, 0], Cc[:, 0],
                                        ssm)
            ssm.copy_(new_ssm)
            y = y + D[None, :, None] * xh.float()
            y = y.reshape(b, 1, dl).to(zx.dtype)
        else:
            xh = xc.reshape(b, t, hl, hd)
            if mode == "prefill":
                y, st = ops.ssd(xh, dt, A, Bc, Cc, return_state=True)
                cache["ssm"].locals[r].copy_(st)
            else:
                y = ops.ssd(xh, dt, A, Bc, Cc)
            y = y + (D[None, None, :, None] * xh.float()).to(y.dtype)
        y = (y.reshape(b, t, dl).float() * F.silu(z.float())).to(zx.dtype)
        yf = y.float()
        return y, torch.sum(yf * yf, dim=-1, keepdim=True)

    parts = g.per_rank(mixer)
    ssq = spmd.all_reduce([q[1] for q in parts], g, tp_axes)
    norm_w = spmd.redistribute(p["norm_w"], (tp_axes,))

    def norm(r):
        y = parts[r][0]
        out = y.float() * torch.rsqrt(ssq[r] / di + cfg.norm_eps)
        return (out * (1.0 + norm_w.locals[r].float())).to(y.dtype)

    y = Sharded(g, g.per_rank(norm), (xg.spec[0], (), tp_axes))
    return _to_residual(_row(y, p["out_proj"], f32=mode != "train"),
                        x.dtype)


def _mamba_whole_spmd(p, xg: Sharded, cfg: ArchConfig, cache, mode):
    """Every shard's :func:`mamba_fwd` on its rows ``xg`` (the sequence
    whole) with the weights gathered: ``(B, T, D)`` rows over dp, whole
    on every model shard. A conv cache split over tp is gathered whole
    for the step and each rank keeps its chunk of what the step wrote;
    the ssm cache, whose heads the axis does not divide, is whole."""
    g = xg.group
    w = {k: spmd.gather_whole(v) for k, v in p.items()}
    conv = None
    if cache is not None:
        conv_c = cache["conv"]
        conv = spmd.redistribute(conv_c, (conv_c.spec[0], (), ()))

    def run(r):
        c = None if cache is None else {"conv": conv.locals[r],
                                        "ssm": cache["ssm"].locals[r]}
        y, _ = mamba_fwd(spmd.local(w, r), xg.locals[r], cfg, cache=c,
                         mode=mode)
        if c is not None and c["conv"] is not cache["conv"].locals[r]:
            cache["conv"].locals[r].copy_(
                spmd.own_chunk(cache["conv"], r, c["conv"]))
        return y
    return Sharded(g, g.per_rank(run), (xg.spec[0], (), ()))

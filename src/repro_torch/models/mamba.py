"""Mamba2 (SSD) mixer block in PyTorch: mamba2-130m's only mixer.

Counterpart of ``repro.models.mamba`` over the same parameter dict (same
keys, shapes, scales and dtypes): fused in_proj -> [z | x | B | C | dt],
causal depthwise conv over [x | B | C], softplus(dt + bias), the SSD core
(K4 on the card through ``kernels.ops.ssd``), per-head D skip, gated
RMSNorm, out_proj. Decode keeps (conv_state, ssm_state) and costs O(1) per
token; the SSD step of decode is plain PyTorch, as the reference's is jnp.
The reference's in-block ``shard(...)`` calls are left out: a block runs
on one device (sharding inside a stage is ROADMAP A23); ``_tp_ok`` and
``mamba_logical`` are the reference's. Caches are written in place, as
the KV cache is.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import axis_size
from repro_torch.kernels import ops
from repro_torch.models.layers import _dtype, _init, rms_norm


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

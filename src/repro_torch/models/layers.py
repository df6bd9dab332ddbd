"""Decoder layers in PyTorch: norm, RoPE, GQA attention, MLP, MoE.

Counterpart of ``repro.models.layers`` over the same nested parameter
dicts (same keys, shapes and dtypes), with the reference's ``*_logical``
trees of logical sharding dims (resolved by ``repro_torch.dist.sharding``)
and ``heads_even``. A layer runs on one device: the reference's in-layer
``shard(...)`` annotations are left out, and MoE takes the reference's
unsharded path. Under an ambient mesh with a model axis, where the
reference takes ``_moe_fwd_shardmap``, :func:`moe_fwd` raises (sharding
inside a stage, ROADMAP A23).

dtype policy as in the reference: params bf16 (cfg.dtype); norms, RoPE and
softmax in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (IN_STAGE_SHARDING, ambient_mesh,
                                       axis_map, axis_size)
from repro_torch.kernels import ops


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def _init(gen: torch.Generator, shape, scale, dtype, device):
    """Normal(0, scale) drawn in fp32 from ``gen`` and cast, like the
    reference's ``_init``; the numbers differ, the distribution does not."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


# ----------------------------------------------------------------------
# norms / rope / activations
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) int. Rotates halves."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions.float()[:, :, None, None] * freqs     # (B,T,1,half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention (GQA + RoPE + window + softcap + KV cache)
# ----------------------------------------------------------------------
def heads_even(cfg: ArchConfig) -> bool:
    """Whether attention heads divide the ambient mesh's model axis (the
    reference's head-parallel test): always with no mesh or ``tp`` 1;
    ``pad_heads`` promotes uneven archs, ``attn_tp=False`` demotes all."""
    if not cfg.attn_tp:
        return False
    tp = axis_size("tp")
    return tp == 1 or cfg.n_heads % tp == 0 or cfg.pad_heads


def init_attention(gen, cfg: ArchConfig, device):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = _dtype(cfg)
    p = {
        "wq": _init(gen, (d, h * dh), d ** -0.5, dt, device),
        "wk": _init(gen, (d, kv * dh), d ** -0.5, dt, device),
        "wv": _init(gen, (d, kv * dh), d ** -0.5, dt, device),
        "wo": _init(gen, (h * dh, d), (h * dh) ** -0.5, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * dh,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * dh,), dtype=dt, device=device)
    return p


def attention_logical(cfg: ArchConfig):
    if not cfg.attn_tp:  # replicated attention weights
        p = {"wq": (None, None), "wk": (None, None), "wv": (None, None),
             "wo": (None, None)}
        if cfg.qkv_bias:
            p.update(bq=(None,), bk=(None,), bv=(None,))
        return p
    p = {"wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
         "wo": ("tp", None)}
    if cfg.qkv_bias:
        p.update(bq=("tp",), bk=("tp",), bv=("tp",))
    return p


def _write_cache(cache: torch.Tensor, new: torch.Tensor, start: int):
    """``cache[:, start:start+t] = new`` in place. A start past ``s - t`` is
    clamped so the write fits, as ``jax.lax.dynamic_update_slice`` clamps
    it. Starts are cache positions, never negative."""
    s, t = cache.shape[1], new.shape[1]
    if t > s:
        raise ValueError(f"{t} new positions do not fit a cache of {s}")
    if int(start) < 0:
        raise ValueError(f"negative cache position {start}")
    start = min(int(start), s - t)
    cache[:, start:start + t] = new.to(cache.dtype)
    return cache


def attention_fwd(
    p,
    x: torch.Tensor,                        # (B, T, D)
    cfg: ArchConfig,
    *,
    local: bool,
    positions: torch.Tensor,                # (B, T)
    segment_ids: Optional[torch.Tensor],    # (B, T) or None
    cache: Optional[dict] = None,           # {"k","v"}: (B, S, KV, Dh)
    cache_pos=None,                         # int: tokens already cached
    mode: str = "train",                    # train | prefill | decode
):
    """Returns ``(y, new_cache)``. In prefill and decode the cache tensors
    are written in place (the reference returns new arrays); ``new_cache``
    holds the same tensors."""
    window = cfg.window if local else 0
    b, t, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, kv, dh)
    v = v.reshape(b, t, kv, dh)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "train":
        out = ops.attention(
            q, k, v, causal=cfg.causal, window=window, softcap=cfg.attn_softcap,
            q_positions=positions, kv_positions=positions,
            q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
        )
    else:
        s = cache["k"].shape[1]
        start = 0 if mode == "prefill" else cache_pos
        ck = _write_cache(cache["k"], k, start)
        cv = _write_cache(cache["v"], v, start)
        new_cache = {"k": ck, "v": cv}
        kv_pos = torch.arange(s, dtype=torch.int32, device=x.device)[None]
        kv_pos = kv_pos.expand(b, s).contiguous()
        # positions beyond the causal frontier hold garbage but are masked
        # (kv_pos > q_pos). decode: q_pos == cache_pos.
        out = ops.attention(
            q, ck, cv, causal=True, window=window, softcap=cfg.attn_softcap,
            q_positions=positions, kv_positions=kv_pos,
        )
    y = out.reshape(b, t, h * dh) @ p["wo"]
    return y, new_cache


# ----------------------------------------------------------------------
# dense MLP
# ----------------------------------------------------------------------
def init_mlp(gen, cfg: ArchConfig, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = {
        "w_in": _init(gen, (d, f), d ** -0.5, dt, device),
        "w_out": _init(gen, (f, d), f ** -0.5, dt, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = _init(gen, (d, f), d ** -0.5, dt, device)
    return p


def mlp_logical(cfg: ArchConfig):
    p = {"w_in": (None, "tp"), "w_out": ("tp", None)}
    if cfg.mlp_gated:
        p["w_gate"] = (None, "tp")
    return p


def mlp_fwd(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = x @ p["w_in"]
    if cfg.mlp_gated:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_out"]


# ----------------------------------------------------------------------
# MoE (top-k, capacity-dropped, scatter/gather dispatch)
# ----------------------------------------------------------------------
def init_moe(gen, cfg: ArchConfig, device):
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    dt = _dtype(cfg)
    p = {
        "router": _init(gen, (d, e), d ** -0.5, torch.float32, device),
        "w_in": _init(gen, (e, d, f), d ** -0.5, dt, device),
        "w_out": _init(gen, (e, f, d), f ** -0.5, dt, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = _init(gen, (e, d, f), d ** -0.5, dt, device)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return p


def moe_logical(cfg: ArchConfig):
    # EP when E % tp == 0; when not (granite's 40 experts on a 16-way
    # axis), the d_ff "tp" dim takes the axis: expert-internal TP
    p = {"router": (None, None), "w_in": ("ep", None, "tp"),
         "w_out": ("ep", "tp", None)}
    if cfg.mlp_gated:
        p["w_gate"] = ("ep", None, "tp")
    if cfg.n_shared_experts:
        p["shared"] = mlp_logical(cfg)
    return p


def moe_capacity(n: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``n`` tokens (padding tokens count, as in the
    reference): ceil(n k / E x capacity_factor), at least 8, aligned up to 8."""
    cap = int(math.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_route(xf: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """The router: fp32 logits, softmax, top-k, the top-k renormalised.
    xf (N, D). Returns ``(probs (N, E), top_p (N, k), top_i (N, k))``.
    Equal probabilities go to the lower expert first, as
    ``jax.lax.top_k`` breaks ties (``torch.topk`` does not promise an
    order): a stable descending sort, then its first k."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def moe_slots(top_i: torch.Tensor, cfg: ArchConfig, cap: int):
    """Each choice's slot in the (E x cap + 1)-row dispatch buffer:
    ``(dests, keeps)``, (k, N) int64 and (k, N) bool. Slots fill choice-major
    as the reference fills them: choice j of token t comes after every
    choice < j and after choice j of every earlier token. A choice past its
    expert's capacity is dropped to the last row, E x cap. Kept slots are
    unique. One scan over the k x N choices, along its inner axis."""
    e = cfg.n_experts
    flat = top_i.t().reshape(-1)                               # (k N,)
    experts = torch.arange(e, device=top_i.device)
    oh = (flat[None, :] == experts[:, None]).to(torch.int32)   # (E, k N)
    pos = torch.cumsum(oh, dim=1).gather(0, flat[None, :])[0] - 1
    keep = pos < cap
    dest = torch.where(keep, flat * cap + pos, e * cap)
    return dest.view(cfg.top_k, -1), keep.view(cfg.top_k, -1)


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig):
    """Returns ``(y, aux)``, aux the Switch load-balance term
    E x sum(frac_tokens x frac_probs). Static shapes throughout: no
    ``nonzero``, boolean indexing or host read, so a decode step adds no
    device synchronisation. The dispatch copies each kept choice into its
    own slot, so the forward sums nothing into a slot. The gather reads
    each kept slot for its one choice; a dropped choice reads slot
    E x cap - 1 at weight 0, so in the backward it adds only a +-0 into
    that slot's gradient, which leaves the sum the same in any order: the
    layer repeats bit for bit."""
    mesh = ambient_mesh()
    if mesh is not None and axis_map(mesh).get("tp"):
        raise NotImplementedError(
            f"{IN_STAGE_SHARDING}: the expert-parallel MoE "
            f"(_moe_fwd_shardmap) on {mesh}")
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    act = act_fn(cfg.act)
    xf = x.reshape(n, d)
    probs, top_p, top_i = moe_route(xf, p["router"], cfg)
    cap = moe_capacity(n, cfg)
    dests, keeps = moe_slots(top_i, cfg, cap)

    buf = xf.new_zeros((e * cap + 1, d))
    # dropped choices all land on the last row, which is cut off
    buf.index_copy_(0, dests.reshape(-1), xf.repeat(k, 1))
    buf = buf[:e * cap].view(e, cap, d)
    h = torch.bmm(buf, p["w_in"])
    if cfg.mlp_gated:
        h = act(torch.bmm(buf, p["w_gate"])) * h
    else:
        h = act(h)
    out = torch.bmm(h, p["w_out"]).view(e * cap, d)

    got = out.index_select(0, dests.clamp(max=e * cap - 1).reshape(-1))
    w = (top_p.t() * keeps).float()                            # (k, N)
    y = (got.view(k, n, d).float() * w[..., None]).sum(dim=0)
    if cfg.n_shared_experts:
        y = y + mlp_fwd(p["shared"], x, cfg).reshape(n, d).float()

    frac_tokens = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.reshape(b, t, d).to(x.dtype), aux

"""Decoder layers in PyTorch: norm, RoPE, GQA attention, MLP, MoE.

Counterpart of ``repro.models.layers`` over the same nested parameter
dicts (same keys, shapes and dtypes), with the reference's ``*_logical``
trees of logical sharding dims (resolved by ``repro_torch.dist.sharding``)
and ``heads_even``. Given tensors, a layer runs on one device and takes
the reference's unsharded path. Given ``spmd.Sharded`` values (inside a
shard group over a (data, model) mesh) it runs each shard's program, as
GSPMD partitions the reference's: attention head-parallel where the heads
divide the model axis (``pad_heads`` pads them there), else
sequence-parallel with the weights gathered where they are used; in
prefill and decode on a KV cache split by rows and by sequence
(:func:`_attention_serve_spmd`: decode merges each shard's K1 partial
over its slice of the cache, ``spmd.merge_attention``); the MLP column-
then row-parallel; the MoE layer as ``_moe_fwd_shardmap`` (dispatch
local to each data shard, capacity from its own tokens, the rows
replicated over the data axes where they do not divide them, experts
split over the model axis or, where they do not divide it, their
``d_ff``, the partial outputs summed over it). :func:`moe_fwd` given
tensors under an ambient mesh with devices and a model axis splits them,
runs that program and joins its output; given tensors under an abstract
mesh, which holds no device and so no group, it raises: a dry run
traces the MoE layer in a shard group on ``meta`` devices
(``launch.mesh.meta_mesh``) instead.

dtype policy as in the reference: params bf16 (cfg.dtype); norms, RoPE and
softmax in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import spmd
from repro_torch.dist.sharding import (IN_STAGE_SHARDING, ambient_mesh,
                                       axis_map, axis_size, map_logical,
                                       shard, spec_for)
from repro_torch.dist.spmd import Sharded
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
    # theta copied to the device from pageable memory: the host waits for
    # the stream to drain
    tracing.count("sync")
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


def _write_start(s: int, t: int, start) -> int:
    """Where ``t`` new positions go in a cache of ``s``: a start past ``s
    - t`` is clamped so the write fits, as ``jax.lax.dynamic_update_slice``
    clamps it. Starts are cache positions, never negative."""
    if t > s:
        raise ValueError(f"{t} new positions do not fit a cache of {s}")
    if int(start) < 0:
        raise ValueError(f"negative cache position {start}")
    return min(int(start), s - t)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, start: int):
    """``cache[:, start:start+t] = new`` in place, the start as
    :func:`_write_start` clamps it."""
    start = _write_start(cache.shape[1], new.shape[1], start)
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)
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
    holds the same tensors. Given a :class:`Sharded` ``x``,
    :func:`_attention_spmd` in training, else :func:`_attention_serve_spmd`
    on a cache of ``spmd.Sharded`` leaves."""
    if isinstance(x, Sharded):
        if mode == "train":
            return _attention_spmd(p, x, cfg, local=local,
                                   positions=positions,
                                   segment_ids=segment_ids), None
        return _attention_serve_spmd(p, x, cfg, local=local,
                                     positions=positions, cache=cache,
                                     cache_pos=cache_pos, mode=mode), cache
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


def _moe_local(x, router, w_in, w_gate, w_out, cfg: ArchConfig, e0: int,
               e_local: int):
    """Dispatch and the expert products over one shard's tokens ``x`` (B,
    T, D) and its experts ``[e0, e0 + e_local)`` (all of them, each its
    slice of d_ff, under expert-internal TP), the reference's
    ``_moe_local_compute``: ``(y (N, D) fp32, aux)``, y this shard's part
    of the output. Capacity comes from these tokens; slots fill as
    :func:`moe_slots` fills them over every expert, and this shard takes
    the kept choices of its own. Static shapes throughout: no ``nonzero``,
    boolean indexing or host read, so a decode step adds no device
    synchronisation. The dispatch copies each kept choice into its own
    slot, so the forward sums nothing into a slot. The gather reads each
    kept slot for its one choice; any other choice reads slot
    e_local x cap - 1 at weight 0, so in the backward it adds only a +-0
    into that slot's gradient, which leaves the sum the same in any order:
    the layer repeats bit for bit."""
    b, t, d = x.shape
    n = b * t
    k = cfg.top_k
    act = act_fn(cfg.act)
    xf = x.reshape(n, d)
    probs, top_p, top_i = moe_route(xf, router, cfg)
    cap = moe_capacity(n, cfg)
    dests, keeps = moe_slots(top_i, cfg, cap)
    ex = top_i.t()
    mine = keeps & (ex >= e0) & (ex < e0 + e_local)
    slot = torch.where(mine, dests - e0 * cap, e_local * cap)

    buf = xf.new_zeros((e_local * cap + 1, d))
    # the choices not kept here all land on the last row, which is cut off
    buf.index_copy_(0, slot.reshape(-1), xf.repeat(k, 1))
    buf = buf[:e_local * cap].view(e_local, cap, d)
    h = torch.bmm(buf, w_in)
    if cfg.mlp_gated:
        h = act(torch.bmm(buf, w_gate)) * h
    else:
        h = act(h)
    out = torch.bmm(h, w_out).view(e_local * cap, d)

    got = out.index_select(0, slot.clamp(max=e_local * cap - 1).reshape(-1))
    w = (top_p.t() * mine).float()                             # (k, N)
    y = (got.view(k, n, d).float() * w[..., None]).sum(dim=0)

    frac_tokens = F.one_hot(top_i[:, 0], cfg.n_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return y, aux


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig):
    """Returns ``(y, aux)``, aux the Switch load-balance term
    E x sum(frac_tokens x frac_probs). Given tensors under an ambient
    mesh with a model axis, :func:`_moe_spmd` through a shard group of
    that mesh (the reference's ``_moe_fwd_shardmap``), which needs the
    mesh's devices; a block inside a shard group calls
    :func:`_moe_spmd` itself."""
    mesh = ambient_mesh()
    if mesh is not None and axis_map(mesh).get("tp"):
        if mesh.devices is None:
            raise NotImplementedError(
                f"{IN_STAGE_SHARDING}: the expert-parallel MoE "
                f"(_moe_fwd_shardmap) on tensors under the abstract "
                f"{mesh}, outside a shard group (a shard group needs "
                f"devices, meta ones for a trace)")
        return _moe_fwd_group(p, x, cfg, mesh)
    b, t, d = x.shape
    n = b * t
    y, aux = _moe_local(x, p["router"], p["w_in"], p.get("w_gate"),
                        p["w_out"], cfg, 0, cfg.n_experts)
    if cfg.n_shared_experts:
        y = y + mlp_fwd(p["shared"], x, cfg).reshape(n, d).float()
    return y.reshape(b, t, d).to(x.dtype), aux


# ----------------------------------------------------------------------
# inside a shard group: each shard's program
# ----------------------------------------------------------------------
def _col(x: Sharded, w: Sharded, bias: Optional[Sharded] = None) -> Sharded:
    """Column-parallel product: x (B, T, D) with D whole, by w (D, F)'s
    local columns: (B, T, F) split as w's columns."""
    if bias is None:
        out = x.group.map(lambda x, w: x @ w, x, w)
    else:
        out = x.group.map(lambda x, w, c: x @ w + c, x, w, bias)
    return Sharded(x.group, out, (x.spec[0], x.spec[1], w.spec[1]))


def _row(x: Sharded, w: Sharded, *, f32: bool = False) -> Sharded:
    """Row-parallel product: x (B, T, F) split on F as w (F, D)'s rows:
    (B, T, D), partial over those axes, in the activations' dtype. With
    ``f32`` (the serving paths) each partial is fp32, unrounded
    (:func:`_mm_f32`), so that its sum over the shards (in fp32) rounds
    once, as one product's accumulator does, and the sharded serve follows
    the serve with no mesh but for the order of fp32 sums;
    :func:`_to_residual` rounds it."""
    if x.spec[2] != w.spec[0]:
        x = spmd.redistribute(x, (x.spec[0], x.spec[1], w.spec[0]))
    mm = _mm_f32 if f32 else torch.matmul
    out = x.group.map(mm, x, w)
    return Sharded(x.group, out, (x.spec[0], x.spec[1], ()),
                   partial=w.spec[0])


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x (..., F), w (F, D)) with an fp32 output: on the card
    (and ``meta``) the product's fp32 accumulator unrounded
    (``torch.mm(..., out_dtype=torch.float32)``), on the CPU the same
    products in fp32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 or x.device.type == "cpu":
        y = x2.float() @ w.float()
    else:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    return y.view(*x.shape[:-1], w.shape[-1])


def _to_residual(y: Sharded, dtype: torch.dtype) -> Sharded:
    """``y`` summed where it is partial, laid out as the residual (rows
    over dp, the sequence over sp) and rounded to ``dtype``."""
    y = shard(y, "dp", "sp", None)
    return y if y.dtype == dtype else y.map(lambda v: v.to(dtype))


def _heads(x: Sharded, n: int, dh: int) -> Sharded:
    """(B, T, n x dh) -> (B, T, n, dh): the fused dim's split kept where
    it falls on head boundaries, else the dim gathered first."""
    axes = x.spec[2]
    if axes and n % x.group.chunk(0, axes)[1]:
        x = spmd.redistribute(x, (x.spec[0], x.spec[1], ()))
        axes = ()
    locs = x.group.map(lambda y: y.reshape(y.shape[0], y.shape[1], -1, dh),
                       x)
    return Sharded(x.group, locs, (x.spec[0], x.spec[1], axes, ()))


def _kv_for(k: torch.Tensor, h: int, q0: int, hl: int) -> torch.Tensor:
    """The KV heads of whole ``k`` (B, S, KV, D) that q heads ``[q0, q0 +
    hl)`` read, as a GQA operand of their own: a contiguous slice where
    the group aligns with them, else one KV head per q head."""
    kv = k.shape[2]
    group = h // kv
    if hl % group == 0:
        return k[:, :, q0 // group:q0 // group + hl // group]
    if group % hl == 0:
        return k[:, :, q0 // group:q0 // group + 1]
    idx = torch.tensor([(q0 + i) // group for i in range(hl)],
                       device=k.device)
    return k.index_select(2, idx)


def _pad_heads_local(q, k, v, cfg: ArchConfig, tp: int):
    """The reference's ``_pad_heads``: q zero-padded to a multiple of
    ``tp`` heads, k and v expanded to one head per q head by the real GQA
    map, the pad heads' k and v zero. Returns ``(q, k, v, hp)``."""
    b, t, h, dh = q.shape
    kv = k.shape[2]
    hp = -(-h // tp) * tp
    group = h // kv
    qmap = torch.tensor([min(i // group, kv - 1) for i in range(h)]
                        + [0] * (hp - h), device=q.device)
    q = F.pad(q, (0, 0, 0, hp - h))
    k = k.index_select(2, qmap)
    v = v.index_select(2, qmap)
    if hp > h:
        mask = (torch.arange(hp, device=q.device) < h).to(k.dtype)
        k = k * mask[None, None, :, None]
        v = v * mask[None, None, :, None]
    return q, k, v, hp


def _rope(x: Sharded, positions: Sharded, cfg: ArchConfig) -> Sharded:
    if not cfg.use_rope:
        return x
    return x.map(lambda x, pos: apply_rope(x, pos, cfg.rope_theta),
                 positions)


def _attention_spmd(p, x: Sharded, cfg: ArchConfig, *, local: bool,
                    positions: Sharded, segment_ids) -> Sharded:
    """Training attention inside a shard group. ``x`` (B, T, D) in the
    residual's layout (rows over dp, sequence over sp); ``positions`` and
    ``segment_ids`` (B, T) rows over dp. Returns y in the residual's
    layout."""
    attend = _attention_heads if heads_even(cfg) else _attention_seq
    y, _, _ = attend(p, x, cfg, local, positions, segment_ids)
    return _to_residual(y, x.dtype)


def _attention_heads(p, x, cfg, local, positions, segment_ids,
                     kv_positions=None, causal=None, f32=False):
    """Head-parallel (Megatron) attention: the sequence gathered, wq, wk
    and wv column-parallel, each shard its q heads; KV heads fewer than
    the model axis gathered whole, each shard taking those its q heads
    read; ``pad_heads`` pads the heads to the axis as the reference's
    ``_pad_heads``; wo row-parallel, its output partial. Returns ``(y, k,
    v)``, k and v (B, T, KV, D) after RoPE, in the layout they were
    computed in (what a prefill writes into its cache). ``kv_positions``
    (default ``positions``) are the keys' positions for the mask and
    ``causal`` (default ``cfg.causal``) its kind; ``f32`` as
    :func:`_row` takes it."""
    g = x.group
    kv_positions = positions if kv_positions is None else kv_positions
    causal = cfg.causal if causal is None else causal
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    xg = shard(x, "dp", None, None)
    q = _heads(_col(xg, p["wq"], p.get("bq")), h, dh)
    k = _heads(_col(xg, p["wk"], p.get("bk")), kv, dh)
    v = _heads(_col(xg, p["wv"], p.get("bv")), kv, dh)
    q, k = _rope(q, positions, cfg), _rope(k, positions, cfg)
    k_out, v_out = k, v
    tp = axis_size("tp")
    n_heads = h
    if cfg.pad_heads and h % tp:
        rows = (q.spec[0], (), (), ())
        q, k, v = (spmd.redistribute(z, rows) for z in (q, k, v))
        padded = g.map(lambda q, k, v: _pad_heads_local(q, k, v, cfg, tp),
                       q, k, v)
        n_heads = padded[0][3]
        lay = spec_for((q.shape[0], q.shape[1], n_heads, dh),
                       ("dp", None, "tp", None))
        q, k, v = (spmd.redistribute(Sharded(g, [o[i] for o in padded],
                                             rows), lay)
                   for i in range(3))
    hl = q.locals[0].shape[2]
    aligned = k.spec[2] == q.spec[2]
    seg = segment_ids
    window = cfg.window if local else 0

    def attend(r):
        qr, kr, vr = q.locals[r], k.locals[r], v.locals[r]
        if not aligned:
            q0 = g.chunk(r, q.spec[2])[0] * hl
            kr, vr = (_kv_for(z, n_heads, q0, hl) for z in (kr, vr))
        sr = None if seg is None else seg.locals[r]
        return ops.attention(
            qr, kr, vr, causal=causal, window=window,
            softcap=cfg.attn_softcap, q_positions=positions.locals[r],
            kv_positions=kv_positions.locals[r], q_segment_ids=sr,
            kv_segment_ids=sr)

    out = Sharded(g, g.per_rank(attend), q.spec)
    if n_heads != h:                                 # drop the pad heads
        out = spmd.redistribute(out, (out.spec[0], (), (), ()))
        out = out.map(lambda o: o[:, :, :h])
    flat = Sharded(g, g.map(lambda o: o.reshape(o.shape[0], o.shape[1], -1),
                            out),
                   (out.spec[0], out.spec[1], out.spec[2]))
    return _row(flat, p["wo"], f32=f32), k_out, v_out


def _attention_seq(p, x, cfg, local, positions, segment_ids,
                   kv_positions=None, causal=None, f32=False):
    """Sequence-parallel attention (heads that do not divide the model
    axis, or ``attn_tp=False``): every weight gathered whole where it is
    used; each shard's q the rows of its sequence chunk at their own
    positions, k and v gathered along the sequence, causal by position;
    the output in the residual's layout, no sum. Returns ``(y, k, v)``
    and takes ``kv_positions``, ``causal`` and ``f32`` as
    :func:`_attention_heads` does."""
    g = x.group
    kv_positions = positions if kv_positions is None else kv_positions
    causal = cfg.causal if causal is None else causal
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    w = {name: spmd.gather_whole(t) for name, t in p.items()}
    q_pos = shard(positions, "dp", "sp")
    q = _heads(_col(x, w["wq"], w.get("bq")), h, dh)
    k = _heads(_col(x, w["wk"], w.get("bk")), kv, dh)
    v = _heads(_col(x, w["wv"], w.get("bv")), kv, dh)
    q, k = _rope(q, q_pos, cfg), _rope(k, q_pos, cfg)
    whole = (x.spec[0], (), (), ())
    k, v = spmd.redistribute(k, whole), spmd.redistribute(v, whole)
    q_seg = None if segment_ids is None else shard(segment_ids, "dp", "sp")
    window = cfg.window if local else 0

    def attend(r):
        return ops.attention(
            q.locals[r], k.locals[r], v.locals[r], causal=causal,
            window=window, softcap=cfg.attn_softcap,
            q_positions=q_pos.locals[r], kv_positions=kv_positions.locals[r],
            q_segment_ids=None if q_seg is None else q_seg.locals[r],
            kv_segment_ids=(None if segment_ids is None
                            else segment_ids.locals[r]))

    out = g.per_rank(lambda r: attend(r).reshape(
        q.locals[r].shape[0], q.locals[r].shape[1], -1))
    flat = Sharded(g, out, (x.spec[0], x.spec[1], ()))
    return _row(flat, w["wo"], f32=f32), k, v


def _write_cache_spmd(cache: Sharded, new: Sharded, start: int) -> None:
    """:func:`_write_cache` on a cache (B, S, KV, D) split by rows and by
    sequence: ``new`` (B, t, KV, D) gathered to the cache's rows with the
    rest whole, the start clamped over the whole S, and each rank writing
    the positions its slice holds (in decode, the one shard whose slice
    holds the new position)."""
    g, t = cache.group, new.shape[1]
    start = _write_start(cache.shape[1], t, start)
    new = spmd.redistribute(new, (cache.spec[0], (), (), ()))

    def write(r):
        c = cache.locals[r]
        n = c.shape[1]
        s0 = g.chunk(r, cache.spec[1])[0] * n
        lo, hi = max(start, s0), min(start + t, s0 + n)
        if lo < hi:
            c[:, lo - s0:hi - s0] = new.locals[r][:, lo - start:hi - start] \
                .to(c.dtype)
    g.per_rank(write)


def _cache_positions(cache: Sharded, r: int) -> torch.Tensor:
    """(B_r, S_r) int32: the cache positions of rank ``r``'s slice."""
    c = cache.locals[r]
    n = c.shape[1]
    s0 = cache.group.chunk(r, cache.spec[1])[0] * n
    return torch.arange(s0, s0 + n, dtype=torch.int32,
                        device=c.device)[None].expand(c.shape[0], n)


def _attention_serve_spmd(p, x: Sharded, cfg: ArchConfig, *, local: bool,
                          positions: Sharded, cache: dict, cache_pos,
                          mode: str) -> Sharded:
    """Prefill and decode inside a shard group, on a KV cache of
    :class:`Sharded` leaves laid out by ``train_state.cache_spec_tree``
    (rows over dp, the sequence over the model axis where it divides).

    Prefill runs the training layout's attention (:func:`_attention_heads`
    or :func:`_attention_seq`, K1's prefill form on every shard) over the
    prompt's keys, causal, at their cache positions ``arange(T)`` (the
    mesh-free prefill attends over the whole cache, whose positions past
    the prompt no prompt position sees), then writes k and v, gathered
    whole, into each rank's slice of the cache: the returned cache has the
    spec tree's layout, which decode takes as it is.

    Decode computes q, k and v column-parallel and gathers them whole (B
    x T x H x D, small), writes the new positions into the shard whose
    slice holds them, runs K1's decode form on each shard's slice for
    every q head (``kv_positions`` its slice of ``arange(S)``, o in fp32
    unrounded), merges the partials over the model axis
    (``spmd.merge_attention``, rounding once), and keeps each shard's
    rows of the flattened heads for wo's row product."""
    g = x.group
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    window = cfg.window if local else 0
    if mode == "prefill":
        t = x.shape[1]
        kv_pos = positions.map(lambda pos: torch.arange(
            t, dtype=torch.int32, device=pos.device)[None].expand(
                pos.shape[0], t))
        attend = _attention_heads if heads_even(cfg) else _attention_seq
        y, k, v = attend(p, x, cfg, local, positions, None,
                         kv_positions=kv_pos, causal=True, f32=True)
        _write_cache_spmd(cache["k"], k, 0)
        _write_cache_spmd(cache["v"], v, 0)
        return _to_residual(y, x.dtype)
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    xg = shard(x, "dp", None, None)
    q = _heads(_col(xg, p["wq"], p.get("bq")), h, dh)
    k = _heads(_col(xg, p["wk"], p.get("bk")), kv, dh)
    v = _heads(_col(xg, p["wv"], p.get("bv")), kv, dh)
    q, k = _rope(q, positions, cfg), _rope(k, positions, cfg)
    rows = (xg.spec[0], (), (), ())
    q, k, v = (spmd.redistribute(z, rows) for z in (q, k, v))
    ck, cv = cache["k"], cache["v"]
    _write_cache_spmd(ck, k, cache_pos)
    _write_cache_spmd(cv, v, cache_pos)

    def attend(r):
        return ops.attention_partial(
            q.locals[r], ck.locals[r], cv.locals[r], causal=True,
            window=window, softcap=cfg.attn_softcap,
            q_positions=positions.locals[r],
            kv_positions=_cache_positions(ck, r))

    parts = g.per_rank(attend)
    o, _ = spmd.merge_attention([a for a, _ in parts], [b for _, b in parts],
                                g, ck.spec[1], dtype=q.dtype)
    flat = Sharded(g, [z.reshape(z.shape[0], z.shape[1], -1) for z in o],
                   (rows[0], (), ()))
    return _to_residual(_row(flat, p["wo"], f32=True), x.dtype)


def _mlp_spmd(p, x: Sharded, cfg: ArchConfig, *, f32=False) -> Sharded:
    """The sequence gathered, w_in and w_gate column-parallel, w_out
    row-parallel (``f32`` as :func:`_row` takes it); the output
    reduce-scattered onto the residual's layout."""
    act = act_fn(cfg.act)
    xg = shard(x, "dp", None, None)
    h = _col(xg, p["w_in"])
    if cfg.mlp_gated:
        h = h.map(lambda h, gt: act(gt) * h, _col(xg, p["w_gate"]))
    else:
        h = h.map(act)
    return _to_residual(_row(h, p["w_out"], f32=f32), x.dtype)


def _moe_spmd(p, x: Sharded, cfg: ArchConfig, *, f32=False):
    """The reference's ``_moe_fwd_shardmap`` on a shard group: each
    shard's :func:`_moe_local` over its data shard's tokens (the sequence
    gathered) and its slice of the experts (EP, where E divides the model
    axis) or of their d_ff (expert-internal TP); the fp32 partial outputs
    reduce-scattered onto the residual's layout and cast; aux averaged
    over the model axis, then over the data axes that split the rows; the
    shared expert, the dense MLP's program (``f32`` its row product's
    partials), added after."""
    g = x.group
    xg = shard(x, "dp", None, None)
    w_in = p["w_in"]
    ep_axes, f_axes = w_in.spec[0], w_in.spec[2]
    e_local = w_in.locals[0].shape[0]
    gate = p.get("w_gate")

    def part(r):
        e0 = g.chunk(r, ep_axes)[0] * e_local if ep_axes else 0
        return _moe_local(xg.locals[r], p["router"].locals[r],
                          w_in.locals[r],
                          None if gate is None else gate.locals[r],
                          p["w_out"].locals[r], cfg, e0, e_local)

    parts = g.per_rank(part)
    b, t, d = xg.locals[0].shape
    y = Sharded(g, g.per_rank(lambda r: parts[r][0].view(b, t, d)),
                (xg.spec[0], (), ()), partial=ep_axes or f_axes)
    auxs = [a for _, a in parts]
    y = shard(y, "dp", "sp", None).map(lambda v: v.to(x.dtype))
    aux = Sharded(g, list(auxs))
    aux = spmd.reduce_over(aux, tuple(axis_map().get("tp", ())), mean=True)
    aux = spmd.reduce_over(aux, xg.spec[0], mean=True)
    if cfg.n_shared_experts:
        y = y.map(torch.add, _mlp_spmd(p["shared"], x, cfg, f32=f32))
    return y, aux


def _moe_fwd_group(p, x: torch.Tensor, cfg: ArchConfig, mesh):
    """:func:`_moe_spmd` on tensors: ``p`` split by :func:`moe_logical`,
    ``x`` by rows over dp, run on a shard group of ``mesh``, y joined
    whole onto ``x``'s device."""
    g = spmd.ShardGroup(mesh)
    specs = map_logical(lambda lg, w: spec_for(tuple(w.shape), lg, mesh),
                        moe_logical(cfg), p)
    with spmd.running(g):
        sp = spmd.split_tree(p, specs, g)
        sx = spmd.split(x, spec_for(tuple(x.shape), ("dp", "sp", None),
                                    mesh), g)
        y, aux = _moe_spmd(sp, sx, cfg)
    return spmd.join(y, x.device), aux.locals[0].to(x.device)

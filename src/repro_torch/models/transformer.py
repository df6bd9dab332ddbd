"""Period-stacked decoder stack and T5-style encoder-decoder in PyTorch.

Counterpart of ``repro.models.transformer``: attention and Mamba2
mixers, each followed by a dense MLP or an MoE layer as the layer's spec
says (jamba's period mixes all four). Parameters keep the reference's
layout: every leaf stacked on a leading ``n_periods`` axis, one period
being one repetition of ``cfg.layer_pattern``. A Python loop over periods
takes the place of ``jax.lax.scan``. In training each period runs under
``torch.utils.checkpoint`` (non-reentrant) in place of the reference's
``jax.checkpoint``, by ``cfg.remat_policy``: "nothing" keeps only the
period inputs for the backward, which recomputes the rest; "dots" also
keeps the outputs of the products without batch dims (``aten.mm`` and
``aten.addmm``, which every weight product lowers to) and recomputes the
rest, attention and the batched expert products among it, as the
reference's ``dots_with_no_batch_dims_saveable``; "everything" runs the
period without checkpoint. The MoE layers' aux
terms are summed per period and over the stack, as the reference sums
them. The encoder-decoder (:func:`init_encdec` to :func:`encdec_fwd`)
adds a period-major stack of cross-attention blocks, one after each
decoder period. ``block_logical``, ``cache_logical`` and ``stack_logical``
are the reference's logical sharding trees; each block's output passes
``shard(h, "dp", "sp", None)``, the identity unless an ambient mesh
would split it (then it raises: sharding inside a stage is ROADMAP A23),
and so does ``_pin_fsdp`` for ``fsdp_params`` archs under an ambient
mesh.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (IN_STAGE_SHARDING, ambient_mesh,
                                       map_logical, shard)
from repro_torch.models import layers as L
from repro_torch.kernels import ops
from repro_torch.models import mamba as M
from repro_torch.tree import leaves, tree_map


# ----------------------------------------------------------------------
# per-layer block
# ----------------------------------------------------------------------
def init_block(gen, cfg: ArchConfig, spec: LayerSpec, device):
    dt = L._dtype(cfg)
    p: dict = {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=device)}
    if spec.mixer == "mamba":
        p["mixer"] = M.init_mamba(gen, cfg, device)
    else:
        p["mixer"] = L.init_attention(gen, cfg, device)
    if spec.moe:
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        p["ffn"] = L.init_moe(gen, cfg, device)
    elif cfg.d_ff:
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        p["ffn"] = L.init_mlp(gen, cfg, device)
    return p


def block_logical(cfg: ArchConfig, spec: LayerSpec):
    p: dict = {"ln1": (None,)}
    p["mixer"] = (M.mamba_logical(cfg) if spec.mixer == "mamba"
                  else L.attention_logical(cfg))
    if spec.moe:
        p["ln2"] = (None,)
        p["ffn"] = L.moe_logical(cfg)
    elif cfg.d_ff:
        p["ln2"] = (None,)
        p["ffn"] = L.mlp_logical(cfg)
    return p


def block_fwd(p, h, cfg: ArchConfig, spec: LayerSpec, *,
              positions, segment_ids, cache=None, cache_pos=None,
              mode="train"):
    """Returns ``(h, new_cache, aux)``; aux is the MoE layer's load-balance
    term, None for a dense layer (the reference's 0, with no launch)."""
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    if spec.mixer == "mamba":    # positions, segment ids, cache_pos unused
        y, new_cache = M.mamba_fwd(p["mixer"], x, cfg, cache=cache, mode=mode)
    else:
        y, new_cache = L.attention_fwd(
            p["mixer"], x, cfg, local=(spec.mixer == "attn_local"),
            positions=positions, segment_ids=segment_ids,
            cache=cache, cache_pos=cache_pos, mode=mode,
        )
    h = h + y
    aux = None
    if "ffn" in p:
        x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
        if spec.moe:
            y, aux = L.moe_fwd(p["ffn"], x, cfg)
        else:
            y = L.mlp_fwd(p["ffn"], x, cfg)
        h = h + y
    return shard(h, "dp", "sp", None), new_cache, aux


# ----------------------------------------------------------------------
# cache construction
# ----------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16,
               device="cuda"):
    """Per-period-position cache, stacked over periods: a tuple of dicts,
    for attention of (n_periods, batch, seq, KV, Dh) k and v, for Mamba of
    the conv state (n_periods, batch, K - 1, conv_ch) in ``dtype`` and the
    ssm state (n_periods, batch, H, P, N) fp32, whatever ``seq``."""
    device = resolve_device(device)
    caches = []
    np_ = cfg.n_periods
    for spec in cfg.layer_pattern:
        if spec.mixer == "mamba":
            _, _, n, hh, conv_ch = M._dims(cfg)
            caches.append({
                "conv": torch.zeros((np_, batch, cfg.ssm_conv - 1, conv_ch),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((np_, batch, hh, cfg.ssm_headdim, n),
                                   dtype=torch.float32, device=device)})
            continue
        shape = (np_, batch, seq, cfg.n_kv_heads, cfg.d_head)
        caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)})
    return tuple(caches)


def cache_logical(cfg: ArchConfig):
    out = []
    for spec in cfg.layer_pattern:
        if spec.mixer == "mamba":
            out.append({"conv": (None, "dp", None, "tp"),
                        "ssm": (None, "dp", "tp", None, None)})
        else:
            # batch over dp, seq over the model axis (flash-decode style:
            # kv heads are usually fewer than the axis)
            out.append({"k": (None, "dp", "sp", None, None),
                        "v": (None, "dp", "sp", None, None)})
    return tuple(out)


# ----------------------------------------------------------------------
# the stack
# ----------------------------------------------------------------------
def _stacked(n: int, make_period):
    """``make_period()`` drawn ``n`` times into one tree of leaf shape
    (n, *leaf_shape), each draw into its slot, so no second copy is held."""
    stack = None
    for i in range(n):
        period = make_period()
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((n, *x.shape)), period)
        tree_map(lambda dst, src, i=i: dst[i].copy_(src), stack, period)
    return stack


def init_stack(gen, cfg: ArchConfig, device):
    """Params stacked over periods: leaf shape (n_periods, *leaf_shape)."""
    return _stacked(cfg.n_periods, lambda: {
        f"l{j}": init_block(gen, cfg, spec, device)
        for j, spec in enumerate(cfg.layer_pattern)})


def stack_logical(cfg: ArchConfig):
    one = {f"l{i}": block_logical(cfg, spec)
           for i, spec in enumerate(cfg.layer_pattern)}
    # the periods axis first, never sharded
    return map_logical(lambda lg: (None,) + lg, one)


def _pin_fsdp(pparams, cfg: ArchConfig):
    """The reference re-asserts ZeRO-3 sharding on each period's weights
    under an ambient mesh for ``fsdp_params`` archs; the port raises there
    (ROADMAP A23) and otherwise returns the weights."""
    mesh = ambient_mesh()
    if mesh is None or not cfg.fsdp_params:
        return pparams
    raise NotImplementedError(
        f"{IN_STAGE_SHARDING}: fsdp_params weights of {cfg.name} on {mesh}")


def _periods(params, n_periods):
    """The period slices of the stacked params. Each leaf is unbound once,
    so under autograd the backward stacks its period gradients a single
    time (``x[i]`` per period would scatter each into a zero-filled
    gradient of the whole stack)."""
    unbound = tree_map(lambda x: x.unbind(0), params)
    return [tree_map(lambda xs, i=i: xs[i], unbound) for i in range(n_periods)]


# the products "dots" saves: those with no batch dims
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpoint of "dots": save what ``DOTS_SAVED`` returns,
    recompute every other op. Nothing else is saved, an allocation least
    of all: the kernels write into ``torch.empty`` outputs outside the
    dispatcher, and a recomputed launch must get a buffer of its own."""
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig):
    """How a training period runs, by ``cfg.remat_policy`` (reference
    ``transformer.py:194-200``): the keyword arguments of its
    ``checkpoint``, or None where it runs without one ("everything")."""
    if cfg.remat_policy == "nothing":
        return {}
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, dots_policy)}
    if cfg.remat_policy == "everything":
        return None
    raise ValueError(f"unknown remat policy {cfg.remat_policy!r} "
                     "(\"nothing\", \"dots\", \"everything\")")


def _period_fwd(pparams, h, cfg: ArchConfig, positions, segment_ids,
                caches, cache_pos, mode):
    """One period's blocks: ``(h, aux)``, aux summed over its MoE layers
    (None where it has none)."""
    aux = None
    for j, spec in enumerate(cfg.layer_pattern):
        h, _, a = block_fwd(
            pparams[f"l{j}"], h, cfg, spec,
            positions=positions, segment_ids=segment_ids,
            cache=None if caches is None else caches[j],
            cache_pos=cache_pos, mode=mode,
        )
        if a is not None:
            aux = a if aux is None else aux + a
    return h, aux


def stack_fwd(params, h, cfg: ArchConfig, *,
              positions, segment_ids, cache=None, cache_pos=None,
              mode="train", remat=True):
    """Loop over periods. Returns ``(h, cache, aux)``; the cache tensors
    (if any) are updated in place and returned, aux is the periods' MoE
    aux summed. ``remat`` recomputes each period in the backward, as
    ``cfg.remat_policy`` says."""
    ckpt = _remat(cfg) if remat else None
    auxs = []
    for i, pparams in enumerate(_periods(params, cfg.n_periods)):
        pparams = _pin_fsdp(pparams, cfg)
        caches = (None if cache is None else
                  [{name: c[i] for name, c in lc.items()} for lc in cache])
        if ckpt is not None:
            h, aux = checkpoint(_period_fwd, pparams, h, cfg, positions,
                                segment_ids, caches, cache_pos, mode,
                                use_reentrant=False, **ckpt)
        else:
            h, aux = _period_fwd(pparams, h, cfg, positions, segment_ids,
                                 caches, cache_pos, mode)
        if aux is not None:
            auxs.append(aux)
    aux = (torch.stack(auxs).sum() if auxs else
           torch.zeros((), dtype=torch.float32, device=h.device))
    return h, cache, aux


# ----------------------------------------------------------------------
# T5-style encoder-decoder (the paper's flagship workload)
# ----------------------------------------------------------------------
def init_encdec(gen, cfg: ArchConfig, device="cuda"):
    """Params ``{embed, enc, dec, cross, enc_norm, dec_norm}`` with the
    reference's keys, shapes and scales, drawn from ``gen`` (on
    ``device``). The cross-attention blocks are stacked *period-major*
    like the encoder and decoder stacks, so decoder stage j owns
    ``cross[j*k:(j+1)*k]`` beside ``dec[j*k:(j+1)*k]``."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, params on {device}")
    dt = L._dtype(cfg)
    embed = L._init(gen, (cfg.vocab_padded, cfg.d_model), 1.0, dt, device)
    enc = init_stack(gen, cfg, device)
    dec = init_stack(gen, cfg, device)
    cross = _stacked(cfg.n_periods, lambda: {
        "ln": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "attn": L.init_attention(gen, cfg, device)})
    return {
        "embed": embed, "enc": enc, "dec": dec, "cross": cross,
        "enc_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "dec_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }


def cross_attention_fwd(p, x, he, cfg: ArchConfig, *,
                        q_segment_ids=None, kv_segment_ids=None):
    """One cross-attention block: queries from the decoder stream ``x``,
    keys and values from the encoder output ``he``, no RoPE and no mask
    but the segments' (padded encoder keys; in packed rows each decoder
    segment on its own encoder segment). Returns the residual delta."""
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    hh, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, t = xn.shape[:2]
    q = (xn @ p["attn"]["wq"]).reshape(b, t, hh, dh)
    k = (he @ p["attn"]["wk"]).reshape(b, -1, kv, dh)
    v = (he @ p["attn"]["wv"]).reshape(b, -1, kv, dh)
    o = ops.attention(q, k, v, causal=False, q_segment_ids=q_segment_ids,
                      kv_segment_ids=kv_segment_ids)
    return o.reshape(b, t, hh * dh) @ p["attn"]["wo"]


def enc_stage_fwd(stack_params, h, cfg: ArchConfig, *,
                  positions, segment_ids=None, remat=True):
    """Encoder slice: the non-causal stack over ``stack_params``' periods
    (``cfg.n_periods`` must be the slice's count). ``h`` is embedded."""
    h, _, _ = stack_fwd(stack_params, h,
                        dataclasses.replace(cfg, causal=False),
                        positions=positions, segment_ids=segment_ids,
                        remat=remat)
    return h


def _dec_period(pparams, cross_p, h, he, cfg: ArchConfig, positions,
                segment_ids, enc_segment_ids):
    h, _ = _period_fwd(pparams, h, cfg, positions, segment_ids, None, None,
                       "train")
    return h + cross_attention_fwd(cross_p, h, he, cfg,
                                   q_segment_ids=segment_ids,
                                   kv_segment_ids=enc_segment_ids)


def dec_stage_fwd(params, hd, he, cfg: ArchConfig, *,
                  positions, segment_ids=None, enc_segment_ids=None,
                  remat=True):
    """Decoder slice: each period's causal self-attention block(s), then
    its cross-attention block against the *final* encoder output ``he``,
    checkpointed together as the reference's ``dec_period`` under
    ``jax.checkpoint``. ``params`` holds period-major ``stack`` and
    ``cross`` slices of equal length."""
    n = next(iter(leaves(params["cross"]))).shape[0]
    for pparams, cross_p in zip(_periods(params["stack"], n),
                                _periods(params["cross"], n)):
        args = (pparams, cross_p, hd, he, cfg, positions, segment_ids,
                enc_segment_ids)
        hd = (checkpoint(_dec_period, *args, use_reentrant=False) if remat
              else _dec_period(*args))
    return hd


def encdec_fwd(params, enc_tokens, dec_tokens, cfg: ArchConfig, *,
               enc_segments=None, dec_segments=None,
               enc_positions=None, dec_positions=None, remat=True):
    """Sequential oracle: the whole encoder-decoder forward from the same
    :func:`enc_stage_fwd` and :func:`dec_stage_fwd` the pipeline slices.
    Returns the decoder's normed hidden states (B, T_dec, D)."""
    def arange(tok):
        b, t = tok.shape
        return torch.arange(t, dtype=torch.int32, device=tok.device)[None] \
            .expand(b, t)

    if enc_positions is None:
        enc_positions = arange(enc_tokens)
    if dec_positions is None:
        dec_positions = arange(dec_tokens)
    he = enc_stage_fwd(params["enc"], params["embed"][enc_tokens], cfg,
                       positions=enc_positions, segment_ids=enc_segments,
                       remat=remat)
    he = L.rms_norm(he, params["enc_norm"], cfg.norm_eps)
    hd = dec_stage_fwd({"stack": params["dec"], "cross": params["cross"]},
                       params["embed"][dec_tokens], he, cfg,
                       positions=dec_positions, segment_ids=dec_segments,
                       enc_segment_ids=enc_segments, remat=remat)
    return L.rms_norm(hd, params["dec_norm"], cfg.norm_eps)

"""Period-stacked decoder stack in PyTorch.

Counterpart of ``repro.models.transformer`` for attention and Mamba2
mixers with dense MLPs. Parameters keep the reference's layout: every leaf stacked on a
leading ``n_periods`` axis, one period being one repetition of
``cfg.layer_pattern``. A Python loop over periods takes the place of
``jax.lax.scan``. In training each period runs under
``torch.utils.checkpoint`` (non-reentrant) in place of the reference's
``jax.checkpoint`` with the "nothing" policy: only the period inputs are
kept for the backward, which recomputes the rest. MoE layers are a later
slice.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.tree import tree_map


def _check_spec(spec: LayerSpec):
    if spec.moe:
        raise NotImplementedError(
            f"layer {spec} is not ported yet (MoE is ROADMAP A15)")


# ----------------------------------------------------------------------
# per-layer block
# ----------------------------------------------------------------------
def init_block(gen, cfg: ArchConfig, spec: LayerSpec, device):
    _check_spec(spec)
    dt = L._dtype(cfg)
    p: dict = {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=device)}
    if spec.mixer == "mamba":
        p["mixer"] = M.init_mamba(gen, cfg, device)
    else:
        p["mixer"] = L.init_attention(gen, cfg, device)
    if cfg.d_ff:
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        p["ffn"] = L.init_mlp(gen, cfg, device)
    return p


def block_fwd(p, h, cfg: ArchConfig, spec: LayerSpec, *,
              positions, segment_ids, cache=None, cache_pos=None,
              mode="train"):
    _check_spec(spec)
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
    if "ffn" in p:
        x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + L.mlp_fwd(p["ffn"], x, cfg)
    return h, new_cache


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
        _check_spec(spec)
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


# ----------------------------------------------------------------------
# the stack
# ----------------------------------------------------------------------
def init_stack(gen, cfg: ArchConfig, device):
    """Params stacked over periods: leaf shape (n_periods, *leaf_shape).
    Each period is drawn into its slot, so no second copy is held."""
    stack = None
    for i in range(cfg.n_periods):
        period = {f"l{j}": init_block(gen, cfg, spec, device)
                  for j, spec in enumerate(cfg.layer_pattern)}
        if stack is None:
            stack = tree_map(
                lambda x: x.new_empty((cfg.n_periods, *x.shape)), period)
        tree_map(lambda dst, src, i=i: dst[i].copy_(src), stack, period)
    return stack


def _periods(params, n_periods):
    """The period slices of the stacked params. Each leaf is unbound once,
    so under autograd the backward stacks its period gradients a single
    time (``x[i]`` per period would scatter each into a zero-filled
    gradient of the whole stack)."""
    unbound = tree_map(lambda x: x.unbind(0), params)
    return [tree_map(lambda xs, i=i: xs[i], unbound) for i in range(n_periods)]


def _remat(cfg: ArchConfig) -> bool:
    """Whether a training period runs under checkpoint, by
    ``cfg.remat_policy`` (reference ``transformer.py:194-200``)."""
    if cfg.remat_policy == "nothing":
        return True
    if cfg.remat_policy == "everything":
        return False
    raise NotImplementedError(
        f"remat policy {cfg.remat_policy!r} is not ported (\"nothing\" and "
        "\"everything\" are)")


def _period_fwd(pparams, h, cfg: ArchConfig, positions, segment_ids,
                caches, cache_pos, mode):
    for j, spec in enumerate(cfg.layer_pattern):
        h, _ = block_fwd(
            pparams[f"l{j}"], h, cfg, spec,
            positions=positions, segment_ids=segment_ids,
            cache=None if caches is None else caches[j],
            cache_pos=cache_pos, mode=mode,
        )
    return h


def stack_fwd(params, h, cfg: ArchConfig, *,
              positions, segment_ids, cache=None, cache_pos=None,
              mode="train", remat=True):
    """Loop over periods. Returns ``(h, cache)``; the cache tensors (if
    any) are updated in place and returned. ``remat`` recomputes each
    period in the backward, as ``cfg.remat_policy`` says."""
    remat = remat and _remat(cfg)
    for i, pparams in enumerate(_periods(params, cfg.n_periods)):
        caches = (None if cache is None else
                  [{name: c[i] for name, c in lc.items()} for lc in cache])
        if remat:
            h = checkpoint(_period_fwd, pparams, h, cfg, positions,
                           segment_ids, caches, cache_pos, mode,
                           use_reentrant=False)
        else:
            h = _period_fwd(pparams, h, cfg, positions, segment_ids, caches,
                            cache_pos, mode)
    return h, cache

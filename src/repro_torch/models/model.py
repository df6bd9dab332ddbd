"""Model facade in PyTorch: init / forward / prefill / decode.

Counterpart of ``repro.models.model`` for the serving path of token-input
models. Parameters are the reference's nested dict (``embed``, the
period-stacked ``stack``, ``final_norm``, ``head`` when untied) with the
same keys, shapes and dtypes; :func:`repro_torch.convert.params_from_jax`
carries a reference tree across. The loss, and the ``frames``/``mixed``
input modes, are later slices.

Entry points run on the card by default. They run on the CPU only when
the caller passes ``device="cpu"``, and raise if CUDA is asked for and is
absent. ``prefill``/``decode`` run where their params and batch lie.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda"):
    """Random params with the reference's shapes and scales. ``gen`` must
    live on ``device``; its numbers differ from ``jax.random``'s."""
    device = resolve_device(device)
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"input mode {cfg.input_mode!r} is not ported")
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, params on {device}")
    dt = L._dtype(cfg)
    p = {
        "embed": L._init(gen, (cfg.vocab_padded, cfg.d_model), 1.0, dt, device),
        "stack": T.init_stack(gen, cfg, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = L._init(gen, (cfg.vocab_padded, cfg.d_model),
                            cfg.d_model ** -0.5, dt, device)
    return p


def _head_weight(params):
    return params.get("head", params["embed"])


# ----------------------------------------------------------------------
# embedding / trunk
# ----------------------------------------------------------------------
def embed_inputs(params, batch, cfg: ArchConfig):
    """Returns h (B, S, D). Token inputs only."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"input mode {cfg.input_mode!r} is not ported")
    h = params["embed"][batch["tokens"]]
    if cfg.scale_embed:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def forward(params, batch, cfg: ArchConfig, *, mode="train",
            cache=None, cache_pos=None):
    h = embed_inputs(params, batch, cfg)
    h, new_cache = T.stack_fwd(
        params["stack"], h, cfg,
        positions=batch["positions"],
        segment_ids=batch.get("segment_ids"),
        cache=cache, cache_pos=cache_pos, mode=mode,
    )
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, new_cache


def _last_logits(params, h, cfg: ArchConfig):
    # logits in the params' dtype (bf16 rounds here), then fp32
    logits = h[:, -1, :] @ _head_weight(params).T
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap)
    return logits.float()


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def prefill(params, batch, cfg: ArchConfig, *, cache_len=None):
    """Full-sequence forward. Returns (last_logits (B,Vp) fp32, cache).

    ``cache_len`` (>= seq len) sizes the KV cache so subsequent decode steps
    have headroom; defaults to the prompt length. Like the reference, the
    logits come from the last column ``h[:, -1]`` of every row."""
    b = batch["positions"].shape[0]
    s = cache_len or batch["positions"].shape[1]
    if cfg.decode:
        cache = T.init_cache(cfg, b, s, dtype=L._dtype(cfg),
                             device=batch["positions"].device)
        h, new_cache = forward(params, batch, cfg, mode="prefill",
                               cache=cache, cache_pos=0)
    else:  # encoder-only: prefill == full encode forward (no cache)
        h, new_cache = forward(params, batch, cfg, mode="train")
    return _last_logits(params, h, cfg), new_cache


def decode(params, batch, cfg: ArchConfig):
    """One decode step. batch: {tokens (B,1), positions (B,1), cache,
    cache_pos (int)}. Returns (logits (B, Vp) fp32, cache), the cache
    written in place."""
    h, new_cache = forward(
        params, batch, cfg, mode="decode",
        cache=batch["cache"], cache_pos=batch["cache_pos"],
    )
    return _last_logits(params, h, cfg), new_cache

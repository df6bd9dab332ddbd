"""Model facade in PyTorch: init / forward / loss / prefill / decode.

Counterpart of ``repro.models.model`` in its three input modes: tokens;
``frames`` (hubert: precomputed frame embeddings through an adapter, a
learned mask embedding on the masked frames); ``mixed`` (llava: patch
embeddings through an adapter, prepended to the token embeddings except
in decode). Parameters are the reference's nested dict (``embed``, the
period-stacked ``stack``, ``final_norm``, ``frame_adapter`` and
``mask_emb`` or ``patch_adapter`` by input mode, ``head`` when untied)
with the same keys, shapes and dtypes, and :func:`params_logical` their
logical sharding dims; :func:`repro_torch.convert.params_from_jax`
carries a reference tree across.

Batch schemas, as in the reference:
  tokens : {tokens, labels, loss_weights, positions, segment_ids}
  mixed  : + patches (B, P, d_model); tokens (B, S - P)
  frames : {frames (B, S, d_model), mask (B, S) bool, labels,
           loss_weights, positions, segment_ids}

Entry points run on the card by default. They run on the CPU only when
the caller passes ``device="cpu"``, and raise if CUDA is asked for and is
absent. ``prefill``/``decode`` run where their params and batch lie.

Under an ambient mesh with devices and a data or model axis
(``spmd.in_stage_mesh``), :func:`loss_fn` runs a shard group of it
(``dist/spmd.py``): the params split by ``train_state.params_spec_tree``
unless they come split, the batch by rows over dp, every shard's program
in lockstep. The embedding is looked up by each shard in its slice of the
table (tied: the vocabulary, the partial rows reduce-scattered onto the
residual's layout; untied: d_model, gathered); the loss gathers the
sequence and takes each shard's logits over its slice of the vocabulary,
still in chunks of at most LOSS_TOKENS tokens, the per-shard log-sum-exps
combined by a log-sum-exp over the shards and the label's logit summed
from the shard that holds it; the sums are then summed over the data axes
that split the rows. Under ``pure_dp`` every axis is a data axis. The
frames and mixed inputs take their adapters column-parallel
(:func:`_embed_spmd`). :func:`prefill` and :func:`decode` run a shard
group the same way, with the serving cache split by
``train_state.cache_spec_tree`` and the last logits a ``spmd.Sharded``
over the vocabulary.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist import spmd
from repro_torch.dist.sharding import ambient_mesh, shard, spec_for
from repro_torch.dist.spmd import Sharded
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

LOSS_CHUNK = 512
# tokens (rows x positions) a loss chunk holds at most: its fp32 logits
# take 4 x vocab bytes a token, 1 GiB per 1024 tokens at gemma2-2b's
# vocabulary of 256000
LOSS_TOKENS = 2048
# weight of the MoE load-balance aux in the loss, the default of the
# reference's loss_fn (model.py:152), which no caller changes
MOE_AUX_WEIGHT = 0.01


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda"):
    """Random params with the reference's shapes and scales. ``gen`` must
    live on ``device``; its numbers differ from ``jax.random``'s. On the
    ``meta`` device (any ``gen``) nothing is allocated: shapes and dtypes
    only."""
    device = resolve_device(device)
    if gen.device.type != device.type and device.type != "meta":
        raise ValueError(f"generator on {gen.device}, params on {device}")
    dt = L._dtype(cfg)
    p = {
        "embed": L._init(gen, (cfg.vocab_padded, cfg.d_model), 1.0, dt, device),
        "stack": T.init_stack(gen, cfg, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.input_mode == "frames":
        p["frame_adapter"] = L._init(gen, (cfg.d_model, cfg.d_model),
                                     cfg.d_model ** -0.5, dt, device)
        p["mask_emb"] = L._init(gen, (cfg.d_model,), 0.02, dt, device)
    if cfg.input_mode == "mixed":
        p["patch_adapter"] = L._init(gen, (cfg.d_model, cfg.d_model),
                                     cfg.d_model ** -0.5, dt, device)
    if not cfg.tie_embeddings:
        p["head"] = L._init(gen, (cfg.vocab_padded, cfg.d_model),
                            cfg.d_model ** -0.5, dt, device)
    return p


def params_logical(cfg: ArchConfig):
    # untied: embed D-sharded (cheap lookup), head vocab-sharded (cheap
    # loss); tied: one table, vocab-sharded for the loss side
    p = {
        "embed": ("tp", None) if cfg.tie_embeddings else (None, "tp"),
        "stack": T.stack_logical(cfg),
        "final_norm": (None,),
    }
    if cfg.input_mode == "frames":
        p["frame_adapter"] = (None, "tp")
        p["mask_emb"] = (None,)
    if cfg.input_mode == "mixed":
        p["patch_adapter"] = (None, "tp")
    if not cfg.tie_embeddings:
        p["head"] = ("tp", None)
    return p


def _head_weight(params):
    return params.get("head", params["embed"])


# ----------------------------------------------------------------------
# embedding / trunk
# ----------------------------------------------------------------------
def embed_inputs(params, batch, cfg: ArchConfig, *, mode="train"):
    """Returns h (B, S, D): frames through the frame adapter, masked frames
    replaced by ``mask_emb``; or patches through the patch adapter ahead of
    the token embeddings (not in decode, whose one token follows the
    cached patches); or the token embeddings. Split params: the token
    embeddings of :func:`_embed_spmd`."""
    if isinstance(params["embed"], Sharded):
        return _embed_spmd(params, batch, cfg, mode)
    dt = L._dtype(cfg)
    if cfg.input_mode == "frames":
        h = batch["frames"].to(dt) @ params["frame_adapter"]
        h = torch.where(batch["mask"][..., None],
                        params["mask_emb"].to(h.dtype), h)
    elif cfg.input_mode == "mixed" and mode != "decode":
        htok = params["embed"][batch["tokens"]]
        hpatch = batch["patches"].to(dt) @ params["patch_adapter"]
        h = torch.cat([hpatch, htok], dim=1)
    else:
        h = params["embed"][batch["tokens"]]
    if cfg.scale_embed:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return shard(h, "dp", "sp", None)


def forward(params, batch, cfg: ArchConfig, *, mode="train",
            cache=None, cache_pos=None, remat=True):
    """Returns ``(h, cache, aux)``: the normed hidden states, the cache
    (written in place) and the stack's MoE aux sum."""
    h = embed_inputs(params, batch, cfg, mode=mode)
    h, new_cache, aux = T.stack_fwd(
        params["stack"], h, cfg,
        positions=batch["positions"],
        segment_ids=batch.get("segment_ids"),
        cache=cache, cache_pos=cache_pos, mode=mode, remat=remat,
    )
    h = T.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, new_cache, aux


# ----------------------------------------------------------------------
# loss (chunked over sequence; logits never fully materialised)
# ----------------------------------------------------------------------
def _masked_logits(head_w, h, cfg: ArchConfig):
    """fp32 logits of h (matmul in h's dtype, as the reference's einsum),
    soft-capped, with the padded vocab entries at -1e30."""
    logits = (h @ head_w.T).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    # in place: neither the cast nor the scalar product saves its output
    return logits.masked_fill_(
        torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab, -1e30)


def _xent_chunk(head_w, h_c, labels_c, w_c, cfg: ArchConfig):
    logits = _masked_logits(head_w, h_c, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels_c[..., None].long())[..., 0]
    w = w_c.float()
    return torch.sum((lse - ll) * w), torch.sum(w)


def _embed_spmd(params, batch, cfg: ArchConfig, mode: str) -> Sharded:
    """:func:`embed_inputs` in a shard group, the result in the residual's
    layout. Tokens: each shard's lookup in its slice of the table, a
    vocabulary slice giving the rows of the tokens it holds and zeros for
    the rest (the partial rows summed over the slices), a d_model slice
    gathered. Frames: the frame adapter column-parallel, ``mask_emb``'s
    matching columns selected on the masked frames. Mixed: the patch
    adapter column-parallel, the patches gathered whole ahead of the token
    embeddings (not in decode)."""
    emb = params["embed"]
    g, dt = emb.group, L._dtype(cfg)
    if cfg.input_mode == "frames":
        frames = batch["frames"].map(lambda f: f.to(dt))
        h = L._col(frames, params["frame_adapter"])
        mask, mask_emb = batch["mask"], params["mask_emb"]

        def sel(r):
            x = h.locals[r]
            i, _ = g.chunk(r, h.spec[2])
            me = mask_emb.locals[r].narrow(0, i * x.shape[2], x.shape[2])
            return torch.where(mask.locals[r][..., None], me.to(x.dtype), x)
        h = Sharded(g, g.per_rank(sel), h.spec)
    else:
        h = _lookup_spmd(emb, batch["tokens"])
        if cfg.input_mode == "mixed" and mode != "decode":
            patches = batch["patches"].map(lambda x: x.to(dt))
            hp = L._col(patches, params["patch_adapter"])
            rows = (h.spec[0], (), ())
            hp, h = spmd.redistribute(hp, rows), spmd.redistribute(h, rows)
            h = Sharded(g, g.map(lambda a, b: torch.cat([a, b], dim=1),
                                 hp, h), rows)
    if cfg.scale_embed:
        h = h.map(lambda x: x * torch.tensor(cfg.d_model ** 0.5,
                                             dtype=x.dtype))
    return shard(h, "dp", "sp", None)


def _lookup_spmd(emb: Sharded, tok: Sharded) -> Sharded:
    """Each shard's token embeddings from its slice of the table: (B, T,
    D) rows as the tokens, D as the table's columns, partial over the
    axes that split the vocabulary."""
    g = emb.group
    vax, n_v = emb.spec[0], emb.locals[0].shape[0]

    def look(r):
        e, t = emb.locals[r], tok.locals[r]
        if not vax:
            return e[t]
        i = t.long() - g.chunk(r, vax)[0] * n_v
        mine = (i >= 0) & (i < n_v)
        return torch.where(mine[..., None], e[i.clamp(0, n_v - 1)],
                           e.new_zeros(()))

    return Sharded(g, g.per_rank(look), (tok.spec[0], (), emb.spec[1]),
                   partial=vax)


def _xent_chunk_spmd(head_w: Sharded, h_c: Sharded, labels_c: Sharded,
                     w_c: Sharded, cfg: ArchConfig):
    """One chunk's ``(loss sum, weight sum)`` on each shard, over its
    data shard's rows, from its slice of the vocabulary: the
    log-sum-exps of the slices combined by a log-sum-exp over the
    shards (an all-gather), the label's logit taken from the slice that
    holds it (an all-reduce of it and zeros)."""
    g = h_c.group
    vax, n_v = head_w.spec[0], head_w.locals[0].shape[0]

    def part(r):
        v0 = g.chunk(r, vax)[0] * n_v
        logits = (h_c.locals[r] @ head_w.locals[r].T).float()
        if cfg.final_softcap:
            logits = cfg.final_softcap * torch.tanh(
                logits / cfg.final_softcap)
        logits = logits.masked_fill_(
            torch.arange(v0, v0 + n_v, device=logits.device) >= cfg.vocab,
            -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        i = labels_c.locals[r].long() - v0
        mine = (i >= 0) & (i < n_v)
        ll = logits.gather(-1, i.clamp(0, n_v - 1)[..., None])[..., 0]
        return lse, torch.where(mine, ll, 0.0)
    parts = g.per_rank(part)
    lses = [p[0] for p in parts]
    lls = [p[1] for p in parts]
    if vax:
        lses = spmd.all_gather(g.per_rank(lambda r: lses[r][None]), g, vax,
                               0)
        lses = g.per_rank(lambda r: torch.logsumexp(lses[r], dim=0))
        lls = spmd.all_reduce(lls, g, vax)

    def sums(r):
        w = w_c.locals[r].float()
        return torch.sum((lses[r] - lls[r]) * w), torch.sum(w)
    parts = g.per_rank(sums)
    return Sharded(g, [p[0] for p in parts]), Sharded(g, [p[1] for p in parts])


def _xent_sums_spmd(head_w: Sharded, h: Sharded, labels: Sharded,
                    weights: Sharded, cfg: ArchConfig):
    """:func:`xent_sums` in a shard group: the sequence gathered, chunks
    of at most LOSS_CHUNK positions and LOSS_TOKENS of a shard's tokens,
    each recomputed in the backward; the sums over the data axes that
    split the rows. Returns replicated scalars."""
    hg = shard(h, "dp", None, None)
    b, t = labels.locals[0].shape
    cap = 1 << max(0, (LOSS_TOKENS // b).bit_length() - 1)
    chunk = min(LOSS_CHUNK, t, cap)
    while t % chunk:
        chunk //= 2

    def cut(s, c0):
        return s.map(lambda x: x[:, c0:c0 + chunk])

    loss_sum = w_sum = None
    for c0 in range(0, t, chunk):
        with spmd.whole_recompute(hg):
            ls, ws = checkpoint(_xent_chunk_spmd, head_w, cut(hg, c0),
                                cut(labels, c0), cut(weights, c0), cfg,
                                use_reentrant=False,
                                **spmd.group_checkpoint(hg, {}))
        loss_sum = ls if loss_sum is None else loss_sum.map(torch.add, ls)
        w_sum = ws if w_sum is None else w_sum.map(torch.add, ws)
    rows = labels.spec[0]
    return spmd.reduce_over(loss_sum, rows), spmd.reduce_over(w_sum, rows)


def xent_sums(head_w, h, labels, weights, cfg: ArchConfig):
    """``(loss sum, weight sum)`` of the softmax-xent. h (B,T,D);
    labels/weights (B,T). Chunked along T, at most LOSS_CHUNK positions and
    LOSS_TOKENS tokens a chunk; each chunk's logits are recomputed in the
    backward, as the reference's ``jax.checkpoint`` on its scan body. The
    training steps sum it over each micro-batch, where the reference's
    ``_xent_sum`` takes the micro-batch's logits at once: at gemma2-2b's
    vocabulary those are 1 GiB of fp32 per 1024 tokens, more than one card
    holds beside the model and its optimizer state."""
    if isinstance(h, Sharded):
        return _xent_sums_spmd(head_w, h, labels, weights, cfg)
    b, t = h.shape[:2]
    # the token cap rounded down to a power of two, so that halving it
    # finds a divisor of t (a multiple of 64) at once
    cap = 1 << max(0, (LOSS_TOKENS // b).bit_length() - 1)
    chunk = min(LOSS_CHUNK, t, cap)
    while t % chunk:
        chunk //= 2
    loss_sum = w_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        ls, ws = checkpoint(_xent_chunk, head_w, h[:, sl], labels[:, sl],
                            weights[:, sl], cfg, use_reentrant=False)
        loss_sum, w_sum = loss_sum + ls, w_sum + ws
    return loss_sum, w_sum


def lm_loss(params, h, labels, weights, cfg: ArchConfig):
    """Chunked softmax-xent (:func:`xent_sums`), the mean over the
    weights."""
    loss_sum, w_sum = xent_sums(_head_weight(params), h, labels, weights, cfg)
    return loss_sum / torch.clamp(w_sum, min=1.0)


def split_batch(batch, group: "spmd.ShardGroup"):
    """Each (B, ...) tensor of a batch split by rows over dp (an entry
    that comes split as it is, and one that is no tensor, as it is)."""
    return {k: spmd.split(v, spec_for(tuple(v.shape), ("dp",), group.mesh),
                          group) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def shard_step_inputs(params, batch, cfg: ArchConfig, group):
    """``(params, batch)`` for a shard group: the params split by
    ``train_state.params_spec_tree`` unless they come split, the batch
    by rows, a decode batch's cache by ``train_state.cache_spec_tree``."""
    from repro_torch.train import train_state as TS
    if not spmd.tree_is_sharded(params):
        params = TS.shard_params(params, cfg, group.mesh)
    sb = split_batch({k: v for k, v in batch.items() if k != "cache"},
                     group)
    if "cache" in batch:
        sb["cache"] = TS.shard_cache(batch["cache"], cfg, group)
    return params, sb


def pin_fsdp_top(params, cfg: ArchConfig):
    """The ZeRO-3 leaves outside the stack (``fsdp_params``: the
    embedding, the head, the final norm) gathered over the zero axes to
    their plain-TP layout, as the stack's periods are
    (``transformer._pin_fsdp``); the stack as it is."""
    if not cfg.fsdp_params:
        return params
    mesh, logical = ambient_mesh(), params_logical(cfg)
    return {k: v if k == "stack" else spmd.redistribute(
        v, spec_for(tuple(v.shape), logical[k], mesh))
        for k, v in params.items()}


def step_group() -> "spmd.ShardGroup":
    """The running shard group where its mesh is the ambient one (a dry
    run opens a representative group), else a new group of the ambient
    mesh."""
    g = spmd.current_group()
    mesh = ambient_mesh()
    return g if g is not None and g.mesh is mesh else spmd.ShardGroup(mesh)


def loss_fn(params, batch, cfg: ArchConfig, *, remat=True):
    """Scalar training loss and its parts: the xent, plus ``MOE_AUX_WEIGHT``
    x the MoE load-balance aux / n_layers for an MoE config. As in the
    reference, the ``"xent"`` entry holds that sum. Under a mesh that
    shards inside the stage, each shard's program in a shard group; the
    values returned are rank 0's."""
    if spmd.in_stage_mesh():
        with spmd.running(step_group()) as g:
            params, sb = shard_step_inputs(params, batch, cfg, g)
            params = pin_fsdp_top(params, cfg)
            h, _, aux = forward(params, sb, cfg, mode="train", remat=remat)
            ls, ws = xent_sums(_head_weight(params), h, sb["labels"],
                               sb["loss_weights"], cfg)
            loss = ls.locals[0] / torch.clamp(ws.locals[0], min=1.0)
            aux = aux.locals[0]
            if cfg.has_moe:
                loss = loss + MOE_AUX_WEIGHT * aux / cfg.n_layers
            return loss, {"xent": loss, "moe_aux": aux}
    h, _, aux = forward(params, batch, cfg, mode="train", remat=remat)
    loss = lm_loss(params, h, batch["labels"], batch["loss_weights"], cfg)
    if cfg.has_moe:
        loss = loss + MOE_AUX_WEIGHT * aux / cfg.n_layers
    return loss, {"xent": loss, "moe_aux": aux}


def _last_logits(params, h, cfg: ArchConfig):
    """fp32 logits of every row's last position. In a shard group each
    shard's over its slice of the vocabulary (the head's rows, after the
    last position is taken from the shard that holds it), the softcap
    applied per shard: a ``Sharded`` (B, Vp), rows over dp and the
    vocabulary over tp, which ``spmd.join`` makes the mesh-free tensor."""
    if isinstance(h, Sharded):
        return _last_logits_spmd(_head_weight(params), h, cfg)
    # logits in the params' dtype (bf16 rounds here), then fp32
    logits = h[:, -1, :] @ _head_weight(params).T
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap)
    return logits.float()


def _last_position(h: Sharded) -> Sharded:
    """``h[:, -1]`` (B, D) on every rank: where the sequence is split,
    the last chunk's owner gives it and the others zeros, summed over the
    axes that split it (a broadcast from the owner)."""
    g, axes = h.group, h.spec[1]
    if not axes:
        return Sharded(g, g.map(lambda x: x[:, -1], h), (h.spec[0],
                                                        h.spec[2]))

    def mine(r):
        x = h.locals[r][:, -1]
        i, n = g.chunk(r, axes)
        return x if i == n - 1 else torch.zeros_like(x)
    return Sharded(g, spmd.all_reduce(g.per_rank(mine), g, axes),
                   (h.spec[0], h.spec[2]))


def _last_logits_spmd(head_w: Sharded, h: Sharded, cfg: ArchConfig):
    g = h.group
    last = spmd.redistribute(_last_position(h), (h.spec[0], ()))
    head_w = spmd.redistribute(head_w, (head_w.spec[0], ()))

    def part(r):
        logits = last.locals[r] @ head_w.locals[r].T
        if cfg.final_softcap:
            logits = cfg.final_softcap * torch.tanh(
                logits.float() / cfg.final_softcap)
        return logits.float()
    return Sharded(g, g.per_rank(part), (last.spec[0], head_w.spec[0]))


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def prefill(params, batch, cfg: ArchConfig, *, cache_len=None):
    """Full-sequence forward. Returns (last_logits (B,Vp) fp32, cache).

    ``cache_len`` (>= seq len) sizes the KV cache so subsequent decode steps
    have headroom; defaults to the prompt length. Like the reference, the
    logits come from the last column ``h[:, -1]`` of every row. Under a
    mesh that shards inside the stage, each shard's program in a shard
    group (:func:`shard_step_inputs`): the logits a ``spmd.Sharded`` over
    the vocabulary, the cache a tree of them laid out by
    ``train_state.cache_spec_tree``."""
    if spmd.in_stage_mesh():
        with spmd.running(step_group()) as g:
            params, sb = shard_step_inputs(params, batch, cfg, g)
            return _prefill(pin_fsdp_top(params, cfg), sb, cfg, cache_len)
    return _prefill(params, batch, cfg, cache_len)


def _prefill(params, batch, cfg: ArchConfig, cache_len):
    pos = batch["positions"]
    b, s = pos.shape[0], cache_len or pos.shape[1]
    if cfg.decode:
        # in a shard group the cache is made on the ranks' devices
        cache = T.init_cache(cfg, b, s, dtype=L._dtype(cfg),
                             device=getattr(pos, "device", "meta"))
        h, new_cache, _ = forward(params, batch, cfg, mode="prefill",
                                  cache=cache, cache_pos=0, remat=False)
    else:  # encoder-only: prefill == full encode forward (no cache)
        h, new_cache, _ = forward(params, batch, cfg, mode="train",
                                  remat=False)
    return _last_logits(params, h, cfg), new_cache


def decode(params, batch, cfg: ArchConfig):
    """One decode step. batch: {tokens (B,1), positions (B,1), cache,
    cache_pos (int)}. Returns (logits (B, Vp) fp32, cache), the cache
    written in place. Under a mesh that shards inside the stage, in a
    shard group as :func:`prefill`: the cache split by its spec tree
    unless it comes split."""
    if spmd.in_stage_mesh():
        with spmd.running(step_group()) as g:
            params, sb = shard_step_inputs(params, batch, cfg, g)
            return _decode(pin_fsdp_top(params, cfg), sb, cfg)
    return _decode(params, batch, cfg)


def _decode(params, batch, cfg: ArchConfig):
    h, new_cache, _ = forward(
        params, batch, cfg, mode="decode",
        cache=batch["cache"], cache_pos=batch["cache_pos"], remat=False,
    )
    return _last_logits(params, h, cfg), new_cache

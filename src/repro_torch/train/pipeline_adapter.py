"""Model <-> executor adapter: the training steps and the stage pipeline.

Counterpart of ``repro.train.pipeline_adapter``:

- :func:`build_grad_step` and :func:`build_encdec_grad_step`, the
  sequential-path steps (one micro-batch's loss and gradient);
- :class:`PipelinedModel`, which splits the period stack into ``n_stages``
  contiguous groups driven by the threaded executor
  (``core/executor.py``): stage 0 also owns the embedding and the
  modality adapters, the last stage the final norm and the head (tied
  embeddings: a second copy of the embedding, whose gradients
  :meth:`PipelinedModel.merge_stage_grads` sums);
- :class:`EncDecPipelinedModel`, the T5 layout: encoder periods on the
  early stages, decoder periods with their cross-attention blocks on the
  later ones, and the final encoder output riding the pipe to every
  decoder stage in the ``(he, hd)`` payload.

A stage forward runs under ``torch.no_grad()`` and stashes only its input,
the quantity the planner's memory model charges. Its backward runs the
stage forward again with gradients on, from detached copies of the stage's
parameter slices and input (stage-granular recompute in place of the
reference's ``jax.vjp``), with the per-period checkpoint inside, and takes
``torch.autograd.grad``. Grad mode and the current CUDA stream are
thread-local, so each stage thread sets both itself: on the card each
stage runs on a CUDA stream of its own. A payload between stages carries
an event recorded on the producer's stream; the consumer's stream waits on
it and claims the tensors with ``record_stream``. Stage streams wait on the
caller's stream when the callbacks are made (the batches and the updated
weights), and :meth:`PipelinedModel.join_streams` makes the caller's
stream wait on every stage before the gradients are merged.

Stage steps are built once per key of the shared ``CompiledStepCache``,
the reference's keys: ``("fwd" | "bwd", namespace, stage) + (mbs, seq)``,
or ``+ (mbs, enc, dec)`` for 2-D micro-batches. The steps close over
static configuration only, never a model.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import StageCallbacks
from repro_torch.core.instructions import ExecutionPlan
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import add_into, flatten, leaves, tree_map, unflatten


def model_cache_namespace(cfg: ArchConfig) -> str:
    """Discriminator prefix for step-cache keys: two configs with equal
    shapes must not share a step. ``repr`` of the config covers every
    field."""
    return repr(cfg)


def _value_and_grad(loss_fn, params):
    """``(loss_sum, w_sum, grads)`` of ``loss_fn(params) -> (loss_sum,
    w_sum)``, the gradient taken from detached leaves so that ``params``
    are not modified; ``grads`` has their structure and dtypes."""
    paths, xs = zip(*flatten(params))
    device = xs[0].device
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in xs]
        with tracing.span("forward", device=device):
            loss_sum, w_sum = loss_fn(unflatten(zip(paths, xs)))
        # zeros for a leaf the loss does not read (hubert's embedding), as
        # jax.grad gives
        with tracing.span("backward", device=device):
            grads = torch.autograd.grad(loss_sum, xs, materialize_grads=True)
    return loss_sum.detach(), w_sum, unflatten(zip(paths, grads))


def _grad_mb_spmd(cfg: ArchConfig, params, batch):
    """:func:`build_grad_step`'s step in a shard group of the ambient mesh:
    each shard's gradient leaves (a tree of ``spmd.Sharded`` in the
    params' layouts), each summed over the ranks that hold copies of its
    slice in ascending rank; the sums are rank 0's."""
    from repro_torch.dist import spmd
    with spmd.running(MD.step_group()) as g:
        sparams, sb = MD.shard_step_inputs(params, batch, cfg, g)

        def f(p):
            p = MD.pin_fsdp_top(p, cfg)
            h, _, _ = MD.forward(p, sb, cfg, mode="train")
            ls, ws = MD.xent_sums(MD._head_weight(p), h, sb["labels"],
                                  sb["loss_weights"], cfg)
            return ls.locals[0], ws.locals[0]
        (loss_sum, w_sum), grads = spmd.value_and_grad(f, sparams)
    return loss_sum, w_sum, grads


def build_grad_step(cfg: ArchConfig):
    """The sequential-path training step: ``grad_mb(params, batch) ->
    (loss_sum, w_sum, grads)``, the value and gradient of the summed xent
    over one micro-batch. Attention runs where the params lie (K1 and the
    fused backward on the card). Like the reference, the step trains on
    the xent alone: an MoE layer's aux term is dropped here. Under a mesh
    that shards inside the stage, :func:`_grad_mb_spmd`."""
    from repro_torch.dist import spmd

    def grad_mb(params, batch):
        if spmd.in_stage_mesh():
            return _grad_mb_spmd(cfg, params, batch)

        def f(p):
            h, _, _ = MD.forward(p, batch, cfg, mode="train")
            return MD.xent_sums(MD._head_weight(p), h, batch["labels"],
                                batch["loss_weights"], cfg)
        return _value_and_grad(f, params)
    return grad_mb


def build_encdec_grad_step(cfg: ArchConfig):
    """Sequential enc-dec training step: the value and gradient of the
    decoder-side summed xent through the :func:`~repro_torch.models.
    transformer.encdec_fwd` oracle (tied embedding head); the enc-dec
    analogue of :func:`build_grad_step`."""

    def grad_mb(params, batch):
        def f(p):
            hd = T.encdec_fwd(
                p, batch["enc_tokens"], batch["dec_tokens"], cfg,
                enc_segments=batch["enc_segment_ids"],
                dec_segments=batch["dec_segment_ids"],
                enc_positions=batch["enc_positions"],
                dec_positions=batch["dec_positions"])
            return MD.xent_sums(p["embed"], hd, batch["labels"],
                                batch["loss_weights"], cfg)
        return _value_and_grad(f, params)
    return grad_mb


def _sub_cfg(cfg: ArchConfig, k: int) -> ArchConfig:
    return dataclasses.replace(cfg, n_layers=k * len(cfg.layer_pattern))


def _stage_apply(cfg: ArchConfig, k: int, n_stages: int, j: int,
                 sparams, x_or_batch, batch_aux):
    """Stage forward, a function of static config: h_out, or ``(loss_sum,
    w_sum)`` on the last stage. The MoE aux term is dropped, as in
    :func:`build_grad_step`."""
    h = MD.embed_inputs(sparams, x_or_batch, cfg) if j == 0 else x_or_batch
    h, _, _ = T.stack_fwd(sparams["stack"], h, _sub_cfg(cfg, k),
                          positions=batch_aux["positions"],
                          segment_ids=batch_aux.get("segment_ids"),
                          remat=True)
    if j == n_stages - 1:
        h = L.rms_norm(h, sparams["final_norm"], cfg.norm_eps)
        head = sparams.get("head", sparams.get("embed"))
        return MD.xent_sums(head, h, batch_aux["labels"],
                            batch_aux["loss_weights"], cfg)
    return h


def _encdec_stage_apply(cfg: ArchConfig, k: int, n_stages: int,
                        n_enc_stages: int, j: int, sparams, x_or_batch,
                        batch_aux):
    """Encoder-decoder stage forward. Stage kinds by position:

      j < n_enc_stages      encoder slice: in batch | he, out he (normed on
                            the last encoder stage)
      j == n_enc_stages     first decoder slice: in he, embeds the decoder
                            tokens itself, out (he, hd)
      j > n_enc_stages      decoder slice: in (he, hd), out (he, hd); he
                            passes through unchanged
      j == n_stages - 1     + decoder norm and loss -> (loss_sum, w_sum)
    """
    sub = _sub_cfg(cfg, k)
    enc_seg = batch_aux["enc_segment_ids"]
    if j < n_enc_stages:
        h = (sparams["embed"][x_or_batch["enc_tokens"]] if j == 0
             else x_or_batch)
        h = T.enc_stage_fwd(sparams["stack"], h, sub,
                            positions=batch_aux["enc_positions"],
                            segment_ids=enc_seg, remat=True)
        if j == n_enc_stages - 1:
            h = L.rms_norm(h, sparams["enc_norm"], cfg.norm_eps)
        return h
    if j == n_enc_stages:
        he, hd = x_or_batch, sparams["embed"][batch_aux["dec_tokens"]]
    else:
        he, hd = x_or_batch
    hd = T.dec_stage_fwd({"stack": sparams["stack"],
                          "cross": sparams["cross"]}, hd, he, sub,
                         positions=batch_aux["dec_positions"],
                         segment_ids=batch_aux["dec_segment_ids"],
                         enc_segment_ids=enc_seg, remat=True)
    if j == n_stages - 1:
        hd = L.rms_norm(hd, sparams["dec_norm"], cfg.norm_eps)
        return MD.xent_sums(sparams["embed"], hd, batch_aux["labels"],
                            batch_aux["loss_weights"], cfg)
    return he, hd


def _stage_fwd_step(apply_fn, static, j):
    """The stage forward with gradients off."""
    def fwd(sp, x, aux):
        with torch.no_grad():
            return apply_fn(*static, j, sp, x, aux)
    return fwd


def _stage_bwd_step(apply_fn, static, j, last):
    """The stage backward: the forward again with gradients on, from
    detached copies of the stage's parameters and of its input, then
    ``torch.autograd.grad``. Returns ``(param grads, input grads)``; the
    input grads mirror the input (None for stage 0's batch, a tensor, or
    the ``(he, hd)`` pair). A decoder stage returns ``he`` unchanged, so
    its incoming ``he`` cotangent is added to the stage's own
    cross-attention contribution, never differentiated through the
    pass-through."""
    def bwd(sp, x, g_out, aux):
        paths, ps = zip(*flatten(sp))
        xs = () if j == 0 else (x if isinstance(x, tuple) else (x,))
        with torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in ps]
            xs = tuple(t.detach().requires_grad_() for t in xs)
            x_in = x if j == 0 else (xs if isinstance(x, tuple) else xs[0])
            out = apply_fn(*static, j, unflatten(zip(paths, ps)), x_in, aux)
            if last:
                outs, g_outs, passed = (out[0],), None, None
            elif isinstance(out, tuple):        # (he, hd): he passed on
                outs, g_outs, passed = (out[1],), (g_out[1],), g_out[0]
            else:
                outs, g_outs, passed = (out,), (g_out,), None
            grads = torch.autograd.grad(outs, [*ps, *xs], g_outs,
                                        materialize_grads=True)
        gp = unflatten(zip(paths, grads[:len(ps)]))
        gx = list(grads[len(ps):])
        if passed is not None:
            gx[0] = gx[0] + passed
        if j == 0:
            return gp, None
        return gp, (tuple(gx) if isinstance(x, tuple) else gx[0])
    return bwd


def stage_slice(cfg: ArchConfig, full, n_stages: int, j: int):
    """Stage ``j``'s params of a decoder model: views of its period slice
    of the stack, and the shared tensors it owns (stage 0 the embedding
    and the modality adapters, the last stage the final norm and the head,
    or the tied embedding)."""
    k = cfg.n_periods // n_stages
    p: dict[str, Any] = {
        "stack": tree_map(lambda x: x[j * k:(j + 1) * k], full["stack"])}
    if j == 0:
        for key in ("embed", "frame_adapter", "mask_emb", "patch_adapter"):
            if key in full:
                p[key] = full[key]
    if j == n_stages - 1:
        p["final_norm"] = full["final_norm"]
        if "head" in full:
            p["head"] = full["head"]
        elif cfg.tie_embeddings:
            p["embed"] = full["embed"]
    return p


class _Payload:
    """Tensors handed from one stage to the next, with the event recorded
    on the producer's stream after it wrote them (None on the CPU)."""
    __slots__ = ("value", "event")

    def __init__(self, value, event):
        self.value, self.event = value, event


def _tensors(x):
    return x if isinstance(x, tuple) else (x,)


class PipelinedModel:
    """A decoder model's stage split over the threaded executor.
    ``params`` is the full parameter tree (:meth:`set_params` swaps it);
    the stages run on the params' device."""

    _aux_keys = ("positions", "segment_ids", "labels", "loss_weights")

    def __init__(self, cfg: ArchConfig, params, n_stages: int,
                 step_cache: Optional[CompiledStepCache] = None):
        self.cfg = cfg
        self.n_stages = n_stages
        self.full_params = params
        self.step_cache = step_cache if step_cache is not None \
            else CompiledStepCache()
        self.streams: Optional[list] = None     # one per stage, on the card
        self._init_layout()

    def _init_layout(self):
        """Validate the stage split and bind the stage-apply function; the
        enc-dec subclass overrides this part of init."""
        cfg, n_stages = self.cfg, self.n_stages
        if cfg.n_periods % n_stages:
            raise ValueError(f"{cfg.name}: n_periods {cfg.n_periods} not "
                             f"divisible by {n_stages} stages")
        self.k = cfg.n_periods // n_stages
        # a shared cache must never hand one config's stage step to another
        # with equal shapes: repr(cfg) covers every field
        self._cache_ns = (repr(cfg), n_stages)
        self._apply_fn = _stage_apply
        self._apply_static = (cfg, self.k, n_stages)

    @staticmethod
    def _batch_shape(b) -> tuple:
        # positions span the whole row in every input mode (frames carry
        # no tokens; mixed rows are patches, then tokens)
        pos = b["positions"]
        return int(pos.shape[0]), int(pos.shape[1])

    def set_params(self, params):
        """Swap in updated weights; the cached stage steps take them as
        arguments."""
        self.full_params = params

    # ------------------------- param slicing ---------------------------
    def stage_params(self, j: int):
        return stage_slice(self.cfg, self.full_params, self.n_stages, j)

    def _stack_keys(self) -> dict:
        """Full-tree stack key -> the stage-tree key of its slices, and the
        stages that hold them."""
        return {"stack": ("stack", range(self.n_stages))}

    def merge_stage_grads(self, stage_grads: list):
        """Per-stage gradient trees -> one full-params tree. Each stack
        slice is written into its place of one full-size tensor; a shared
        tensor's gradients (the tied embedding) are summed in ascending
        stage order. Runs on the caller's stream, which has joined every
        stage's (:meth:`join_streams`)."""
        on_cuda = self.streams is not None
        if on_cuda:                 # the caller's stream reads them now
            cur = torch.cuda.current_stream()
            for g in stage_grads:
                for x in leaves(g):
                    x.record_stream(cur)
        out: dict[str, Any] = {}
        for full_key, (key, stages) in self._stack_keys().items():
            full = tree_map(torch.empty_like, self.full_params[full_key])
            k = self.k
            for i, j in enumerate(stages):
                tree_map(lambda dst, src: dst[i * k:(i + 1) * k].copy_(src),
                         full, stage_grads[j][key])
            out[full_key] = full
        for g in stage_grads:
            for key, val in g.items():
                if key in ("stack", "cross"):
                    continue
                out[key] = val if key not in out else out[key].add_(val)
        return out

    # ------------------------- streams ---------------------------------
    def _open_streams(self, device):
        """One CUDA stream per stage, made once; every stage stream then
        waits on the caller's stream (the batches just copied and the
        weights last updated there)."""
        if device.type != "cuda":
            self.streams = None
            return
        if self.streams is None:
            self.streams = [torch.cuda.Stream(device)
                            for _ in range(self.n_stages)]
        cur = torch.cuda.current_stream(device)
        for s in self.streams:
            s.wait_stream(cur)

    def join_streams(self):
        """Make the caller's stream wait on every stage stream."""
        if self.streams is not None:
            cur = torch.cuda.current_stream()
            for s in self.streams:
                cur.wait_stream(s)

    # ------------------------- callbacks -------------------------------
    def make_callbacks(self, plan: ExecutionPlan, batches: dict
                       ) -> tuple[list[StageCallbacks], dict]:
        """``batches``: mb_id -> batch dict (numpy arrays or tensors),
        copied to the params' device here, on the caller's stream.

        Returns ``(callbacks, result)``; after the executor ran, ``result``
        holds ``stage_grads`` (one tree per stage, summed in place in the
        plan's backward order), ``loss_sum`` and ``weight_sum``.
        """
        c = self.n_stages
        device = leaves(self.full_params)[0].device
        batches = {mb: {key: torch.as_tensor(v).to(device)
                        for key, v in b.items()}
                   for mb, b in batches.items()}
        self._open_streams(device)
        streams = self.streams
        result = {"stage_grads": [None] * c, "loss_sum": 0.0,
                  "weight_sum": 0.0}
        sparams = [self.stage_params(j) for j in range(c)]
        stashes: list[dict] = [dict() for _ in range(c)]
        aux_keys = self._aux_keys

        def aux_of(mb):
            return {key: batches[mb][key] for key in aux_keys
                    if key in batches[mb]}

        def shape_of(mb):
            return self._batch_shape(batches[mb])

        # the cached steps close over static config only, never ``self``
        apply_fn, static = self._apply_fn, self._apply_static

        def step(kind, j, mb):
            build = (lambda: _stage_fwd_step(apply_fn, static, j)) \
                if kind == "fwd" else \
                (lambda: _stage_bwd_step(apply_fn, static, j, j == c - 1))
            return self.step_cache.get((kind, self._cache_ns, j)
                                       + shape_of(mb), build)

        def stream_of(j):
            return (torch.cuda.stream(streams[j]) if streams is not None
                    else contextlib.nullcontext())

        def receive(j, payload: _Payload):
            """The producer's tensors, once this stage's stream has waited
            for them and claimed them from the allocator."""
            if payload.event is not None:
                streams[j].wait_event(payload.event)
                for t in _tensors(payload.value):
                    t.record_stream(streams[j])
            return payload.value

        def send(j, value):
            ev = None
            if streams is not None:
                ev = torch.cuda.Event()
                ev.record(streams[j])
            return _Payload(value, ev)

        def make_forward(j):
            def forward(mb, h_in=None):
                with stream_of(j):
                    x = batches[mb] if j == 0 else receive(j, h_in)
                    stashes[j][mb] = x
                    out = step("fwd", j, mb)(sparams[j], x, aux_of(mb))
                    if j == c - 1:
                        loss_sum, w_sum = out
                        result["loss_sum"] += float(loss_sum)
                        result["weight_sum"] += float(w_sum)
                        return None
                    return send(j, out)
            return forward

        def make_backward(j):
            def backward(mb, g_out):
                with stream_of(j):
                    x = stashes[j].pop(mb)
                    g = None if j == c - 1 else receive(j, g_out)
                    gp, gx = step("bwd", j, mb)(sparams[j], x, g, aux_of(mb))
                    acc = result["stage_grads"][j]
                    result["stage_grads"][j] = (gp if acc is None
                                                else add_into(acc, gp))
                    return None if j == 0 else send(j, gx)
            return backward

        # REDUCE_AND_STEP: the update runs after the executor, on the
        # merged gradients
        cbs = [StageCallbacks(make_forward(j), make_backward(j), lambda: None)
               for j in range(c)]
        return cbs, result


class EncDecPipelinedModel(PipelinedModel):
    """Encoder-decoder stage layout over the same executor plumbing.

    The model's ``2 · n_periods`` periods (encoder, then decoder) split
    into ``n_stages`` contiguous groups of ``k`` periods; the enc/dec
    boundary must fall on a stage boundary, so encoder periods occupy
    stages ``0..E-1`` and decoder periods (each with its cross-attention
    block) stages ``E..c-1``. Stage 0 owns the embedding, the first
    decoder stage a copy (the decoder's lookup) and the last stage a
    third (the tied head); their gradients are summed in that order. The
    final encoder output ``he`` rides the pipe to every decoder stage in
    the ``(he, hd)`` payload, and its gradient comes back the same way.
    """

    _aux_keys = ("enc_positions", "enc_segment_ids", "dec_tokens",
                 "dec_positions", "dec_segment_ids", "labels", "loss_weights")

    def _init_layout(self):
        cfg, n_stages = self.cfg, self.n_stages
        self.k, self.n_enc_stages = self.layout(cfg, n_stages)
        self._cache_ns = ("encdec", repr(cfg), n_stages)
        self._apply_fn = _encdec_stage_apply
        self._apply_static = (cfg, self.k, n_stages, self.n_enc_stages)

    @staticmethod
    def layout(cfg: ArchConfig, n_stages: int) -> tuple[int, int]:
        """(periods per stage, number of encoder stages); raises when the
        2·n_periods total does not split evenly or a stage would straddle
        the encoder/decoder boundary."""
        total = 2 * cfg.n_periods
        if n_stages < 2 or total % n_stages:
            raise ValueError(
                f"{cfg.name}: {total} enc+dec periods do not split over "
                f"{n_stages} stages")
        k = total // n_stages
        if cfg.n_periods % k:
            raise ValueError(
                f"{cfg.name}: stage of {k} periods straddles the enc/dec "
                f"boundary at period {cfg.n_periods}")
        return k, cfg.n_periods // k

    @staticmethod
    def _batch_shape(b) -> tuple:
        enc, dec = b["enc_tokens"], b["dec_tokens"]
        return int(enc.shape[0]), int(enc.shape[1]), int(dec.shape[1])

    # ------------------------- param slicing ---------------------------
    def stage_params(self, j: int):
        k, e, full = self.k, self.n_enc_stages, self.full_params

        def sl(tree, i):
            return tree_map(lambda x: x[i * k:(i + 1) * k], tree)

        p: dict[str, Any] = {}
        if j < e:
            p["stack"] = sl(full["enc"], j)
            if j == e - 1:
                p["enc_norm"] = full["enc_norm"]
        else:
            p["stack"] = sl(full["dec"], j - e)
            p["cross"] = sl(full["cross"], j - e)
            if j == self.n_stages - 1:
                p["dec_norm"] = full["dec_norm"]
        if j in (0, e, self.n_stages - 1):
            p["embed"] = full["embed"]
        return p

    def _stack_keys(self) -> dict:
        e, c = self.n_enc_stages, self.n_stages
        return {"enc": ("stack", range(e)), "dec": ("stack", range(e, c)),
                "cross": ("cross", range(e, c))}


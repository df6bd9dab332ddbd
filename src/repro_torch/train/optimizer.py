"""AdamW with global-norm clipping and optional bf16-compressed
(error-feedback) gradient reduction, from ``repro.train.optimizer``.

State layout (mixed precision), as in the reference:
  params      bf16 (the compute copy)
  master      fp32 (source of truth)
  m, v        fp32
  err         bf16 error-feedback accumulator (only when compression is on)

Unlike the reference's pure function, :func:`adamw_update` updates
``master``, ``m``, ``v`` and the params in place, one slice of a leaf at a
time, so an update at full width needs no second copy of the state. It
returns the same objects.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tracing
from repro_torch.tree import leaves, tree_map

# elements of one leaf updated at a time: bounds the fp32 temporaries
_SLICE = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False   # bf16 + error feedback on the DP reduce


def init_opt_state(params, cfg: AdamWConfig):
    state = {
        "step": 0,
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
    }
    if cfg.compress_grads:
        state["err"] = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.bfloat16), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
          for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def compress_for_reduce(grads, state, cfg: AdamWConfig):
    """bf16 gradient compression with error feedback: the DP all-reduce
    moves half the bytes; quantization error is carried to the next step."""
    if not cfg.compress_grads:
        return grads, state
    corrected = tree_map(lambda g, e: g.float() + e.float(), grads, state["err"])
    compressed = tree_map(lambda g: g.to(torch.bfloat16), corrected)
    new_err = tree_map(lambda c, comp: (c - comp.float()).to(torch.bfloat16),
                   corrected, compressed)
    return compressed, dict(state, err=new_err)


def _update_leaf(p, g, m, v, ma, scale, b1c, b2c, cfg: AdamWConfig):
    """One leaf's AdamW update, in place, a slice at a time: ``m``, ``v``
    and ``ma`` (master) contiguous fp32, ``p`` the params' view of the
    same elements, or None (then the caller writes them from ``ma``)."""
    g, m, v, ma = (x.view(-1) for x in (g.contiguous(), m, v, ma))
    p = None if p is None else p.view(-1)
    for i in range(0, g.numel(), _SLICE):
        sl = slice(i, i + _SLICE)
        gs = g[sl].float() * scale
        ms = m[sl].mul_(cfg.b1).add_(gs, alpha=1 - cfg.b1)
        vs = v[sl].mul_(cfg.b2).addcmul_(gs, gs, value=1 - cfg.b2)
        upd = (ms / b1c) / (torch.sqrt(vs / b2c) + cfg.eps)
        mas = ma[sl]
        mas.sub_(cfg.lr * (upd + cfg.weight_decay * mas))
        if p is not None:
            p[sl].copy_(mas)


def step_scalars(grads, state, cfg: AdamWConfig):
    """``(grad_norm, clip scale, step, b1c, b2c)`` of the next update: the
    global norm of the whole gradients, the step count after it and the
    bias corrections."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state["step"] + 1
    return gnorm, scale, step, 1.0 - cfg.b1 ** step, 1.0 - cfg.b2 ** step


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns ``(params, state, metrics)``; params and state are updated in
    place (see the module docstring), so an exception escaping from inside
    leaves the state torn between two steps (the runner checkpoints no
    such state)."""
    p_l = leaves(params)
    with tracing.span("optimizer", device=p_l[0].device):
        gnorm, scale, step, b1c, b2c = step_scalars(grads, state, cfg)
        for p, g, m, v, ma in zip(p_l, leaves(grads), leaves(state["m"]),
                                  leaves(state["v"]), leaves(state["master"])):
            _update_leaf(p, g, m, v, ma, scale, b1c, b2c, cfg)
        state["step"] = step
    return params, state, {"grad_norm": gnorm}


def sharded_adamw_update(sparams, grads, state, cfg: AdamWConfig):
    """:func:`adamw_update` in a shard group: ``sparams`` and ``grads``
    trees of ``spmd.Sharded`` in the params' layouts, ``state``'s
    ``master``, ``m`` and ``v`` in their ZeRO-1 layouts (ZeRO-3 params
    share them). Each rank updates its own chunk of each leaf, in place;
    where the params' layout holds more than that chunk, the updated
    chunks are gathered over the zero axes into it (cast to the params'
    dtype), as ZeRO-1's all-gather does. The global norm sums each
    chunk's squares once (divided by its copies), then over every rank
    (one all-reduce). Returns ``(sparams, state, metrics)``."""
    from repro_torch.dist import spmd

    p_l, g_l = leaves(sparams), leaves(grads)
    ma_l, m_l, v_l = (leaves(state[k]) for k in ("master", "m", "v"))
    group = p_l[0].group

    def own(r, p, g, z):
        """Rank r's zero chunk of g, a view of its local."""
        x = g.locals[r]
        shape = p.shape
        for (d, ps, _), (_, zs, zn) in zip(
                spmd._chunk_slices(group, r, p.spec, shape),
                spmd._chunk_slices(group, r, z.spec, shape)):
            if zn != x.shape[d]:
                x = x.narrow(d, zs - ps, zn)
        return x

    def sumsq(r):
        tot = None
        for p, g, z in zip(p_l, g_l, m_l):
            copies = spmd._size(group, spmd.replica_axes(z))
            sq = torch.linalg.vector_norm(own(r, p, g, z),
                                          dtype=torch.float32) ** 2 / copies
            tot = sq if tot is None else tot + sq
        return tot
    total = spmd.all_reduce(group.per_rank(sumsq), group, group.axis_names)
    gnorm = torch.sqrt(total[0])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = state["step"] + 1
    b1c, b2c = 1.0 - cfg.b1 ** step, 1.0 - cfg.b2 ** step
    for p, g, ma, m, v in zip(p_l, g_l, ma_l, m_l, v_l):
        same = p.spec == ma.spec

        def upd(r, p=p, g=g, ma=ma, m=m, v=v, same=same):
            sc = scale.to(g.locals[r].device)
            _update_leaf(p.locals[r] if same else None, own(r, p, g, ma),
                         m.locals[r], v.locals[r], ma.locals[r], sc, b1c,
                         b2c, cfg)
        group.per_rank(upd)
        if not same:
            cast = ma.map(lambda x, dt=p.dtype: x.to(dt))
            new = spmd.redistribute(cast, p.spec)
            group.per_rank(lambda r, p=p, new=new:
                           p.locals[r].copy_(new.locals[r]))
    state["step"] = step
    return sparams, state, {"grad_norm": gnorm}

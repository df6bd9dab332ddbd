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
    """One leaf's AdamW update, in place, a slice at a time."""
    p, g, m, v, ma = (x.view(-1) for x in (p, g.contiguous(), m, v, ma))
    for i in range(0, g.numel(), _SLICE):
        sl = slice(i, i + _SLICE)
        gs = g[sl].float() * scale
        ms = m[sl].mul_(cfg.b1).add_(gs, alpha=1 - cfg.b1)
        vs = v[sl].mul_(cfg.b2).addcmul_(gs, gs, value=1 - cfg.b2)
        upd = (ms / b1c) / (torch.sqrt(vs / b2c) + cfg.eps)
        mas = ma[sl]
        mas.sub_(cfg.lr * (upd + cfg.weight_decay * mas))
        p[sl].copy_(mas)


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns ``(params, state, metrics)``; params and state are updated in
    place (see the module docstring), so an exception escaping from inside
    leaves the state torn between two steps (the runner checkpoints no
    such state)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for p, g, m, v, ma in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"]),
                              leaves(state["master"])):
        _update_leaf(p, g, m, v, ma, scale, b1c, b2c, cfg)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}

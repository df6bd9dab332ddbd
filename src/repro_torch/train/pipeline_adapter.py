"""The sequential-path training step of ``repro.train.pipeline_adapter``.

Only :func:`build_grad_step` and :func:`_xent_sum` are ported: the step the
runner's sequential path and ``benchmarks/bench_e2e.py`` use. The stage
split (``PipelinedModel``) and the encoder-decoder step are later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as MD
from repro_torch.tree import flatten, unflatten


def model_cache_namespace(cfg: ArchConfig) -> str:
    """Discriminator prefix for step-cache keys: two configs with equal
    shapes must not share a step. ``repr`` of the config covers every
    field."""
    return repr(cfg)


def build_grad_step(cfg: ArchConfig):
    """The sequential-path training step: ``grad_mb(params, batch) ->
    (loss_sum, w_sum, grads)``, the value and gradient of the summed xent
    over one micro-batch. ``grads`` has the params' structure and dtypes.
    The params are not modified; attention runs where they lie (K1, K2 and
    K3 on the card)."""

    def grad_mb(params, batch):
        paths, leaves = zip(*flatten(params))
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in leaves]
            p = unflatten(zip(paths, leaves))
            h, _ = MD.forward(p, batch, cfg, mode="train")
            loss_sum, w_sum = _xent_sum(MD._head_weight(p), h,
                                        batch["labels"],
                                        batch["loss_weights"], cfg)
            grads = torch.autograd.grad(loss_sum, leaves)
        return loss_sum.detach(), w_sum, unflatten(zip(paths, grads))
    return grad_mb


def _xent_sum(head_w, h, labels, weights, cfg: ArchConfig):
    """Sum (not mean) xent + weight sum over the whole micro-batch: the
    function of one ``lm_loss`` chunk. Summed across micro-batches, the
    iteration mean is taken once at optimizer time."""
    return MD._xent_chunk(head_w, h, labels, weights, cfg)

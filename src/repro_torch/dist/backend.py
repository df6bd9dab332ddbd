"""ExecutionBackend and the threads backend's sequential path.

Counterpart of ``repro.dist.backend``. The planner emits
:class:`~repro_torch.core.instructions.ExecutionPlan`s; a backend turns one
replica's plan into gradients. Ported so far:

- :class:`ThreadsBackend` with ``n_stages == 1`` (or ``use_executor=False``):
  the sequential per-micro-batch grad loop of the reference
  (``dist/backend.py:227-243``), gradients summed in place over the
  micro-batches.

Where the reference would run the threaded stage pipeline
(``use_executor`` with ``n_stages > 1``, ROADMAP A9), verify plans
(``strict``, A4), train an encoder-decoder model (A11) or take the mesh
backend (A13), this module raises
``NotImplementedError``: it never runs something else in their place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.instructions import ExecutionPlan
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.pipeline_adapter import (build_grad_step,
                                                model_cache_namespace)
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import leaves


@dataclass
class BackendResult:
    """What executing one replica's plan produced.

    ``timings`` entries are ``(kind, mb_id, seconds)``; the sequential path
    records ``"total"`` (forward and backward of the micro-batch).
    """
    grads: Any
    loss_sum: float
    weight_sum: float
    timings: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)


class ExecutionBackend:
    """Protocol of the execution planes: ``execute_plan(plan, *, params,
    batches, collect_timings=False) -> BackendResult`` runs one replica's
    plan;
    :meth:`place_opt_state` / :meth:`optimizer_step` own the optimizer's
    layout (the default: one device, eager AdamW)."""

    name = "abstract"

    def execute_plan(self, plan: ExecutionPlan, *, params=None, batches=None,
                     collect_timings: bool = False) -> BackendResult:
        raise NotImplementedError

    def place_opt_state(self, opt_state):
        return opt_state

    def optimizer_step(self, params, grads, opt_state, opt_cfg):
        return adamw_update(params, grads, opt_state, opt_cfg)


def add_into(acc, g):
    """``acc += g`` leaf by leaf, in place; returns ``acc``."""
    for a, b in zip(leaves(acc), leaves(g)):
        a.add_(b)
    return acc


class ThreadsBackend(ExecutionBackend):
    """Host plane, sequential path: each micro-batch's grad step in turn,
    on ``device``, gradients accumulated in place."""

    name = "threads"

    def __init__(self, cfg: ArchConfig, n_stages: int,
                 step_cache: Optional[CompiledStepCache] = None, *,
                 use_executor: bool = True, strict: bool = False,
                 device="cuda"):
        if cfg.family == "encdec":
            raise NotImplementedError(
                "encoder-decoder training is not ported yet (ROADMAP A11)")
        if use_executor and n_stages > 1 and cfg.n_periods % n_stages == 0:
            raise NotImplementedError(
                "the threaded stage pipeline (use_executor with n_stages > 1) "
                "is not ported yet (ROADMAP A9); pass use_executor=False for "
                "the sequential path")
        if strict:
            raise NotImplementedError(
                "strict plan verification is not ported yet (ROADMAP A4)")
        self.cfg = cfg
        self.n_stages = n_stages
        self.step_cache = step_cache if step_cache is not None \
            else CompiledStepCache()
        self.device = torch.device(device)

    def _grad_fn(self, shape: tuple):
        key = ("grad", model_cache_namespace(self.cfg)) + shape
        return self.step_cache.get(key, lambda: build_grad_step(self.cfg))

    @staticmethod
    def _batch_shape(b) -> tuple:
        return int(b["tokens"].shape[0]), int(b["tokens"].shape[1])

    def execute_plan(self, plan: ExecutionPlan, *, params=None, batches=None,
                     collect_timings: bool = False) -> BackendResult:
        if not plan.micro_batches:
            return BackendResult(None, 0.0, 0.0)

        grads, loss_sum, w_sum = None, 0.0, 0.0
        timings: list = []
        for mb_id in sorted(batches):
            b = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batches[mb_id].items()}
            t0 = time.perf_counter()
            ls, ws, g = self._grad_fn(self._batch_shape(b))(params, b)
            loss_sum += float(ls)    # float() syncs: t0..here is real compute
            w_sum += float(ws)
            if collect_timings:
                timings.append(("total", mb_id, time.perf_counter() - t0))
            grads = g if grads is None else add_into(grads, g)
            del g
        return BackendResult(grads, loss_sum, w_sum, timings)


def make_backend(name: str, cfg: ArchConfig, n_stages: int, *,
                 step_cache: Optional[CompiledStepCache] = None,
                 use_executor: bool = True, strict: bool = False,
                 device="cuda") -> ExecutionBackend:
    """Backend factory keyed by ``RunnerConfig.backend``."""
    if name == "threads":
        return ThreadsBackend(cfg, n_stages, step_cache=step_cache,
                              use_executor=use_executor, strict=strict,
                              device=device)
    if name == "mesh":
        raise NotImplementedError(
            "the mesh backend is not ported yet (ROADMAP A13)")
    if name == "process":
        raise ValueError(
            "the process backend is not built by the factory; it is the "
            "process fault domain, which is not ported yet (ROADMAP A14)")
    raise ValueError(f"unknown execution backend {name!r}; "
                     "expected 'threads' or 'mesh'")

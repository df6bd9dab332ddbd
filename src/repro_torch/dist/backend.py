"""ExecutionBackend and the threads backend.

Counterpart of ``repro.dist.backend``. The planner emits
:class:`~repro_torch.core.instructions.ExecutionPlan`s; a backend turns one
replica's plan into gradients. :class:`ThreadsBackend` is the host plane:

- the threaded stage pipeline, when ``use_executor`` and the model's
  periods split evenly over ``n_stages > 1`` (for an encoder-decoder
  model the stage boundary must also fall on the enc/dec boundary):
  ``core/executor.py`` runs one thread per stage over a
  :class:`~repro_torch.train.pipeline_adapter.PipelinedModel` or
  :class:`~repro_torch.train.pipeline_adapter.EncDecPipelinedModel`, each
  stage on its own CUDA stream on the card;
- otherwise the sequential per-micro-batch grad loop (``build_grad_step``,
  or ``build_encdec_grad_step`` for 2-D micro-batches), gradients summed in
  place; with identical math;
- ``callbacks=``: the raw host plane, the caller's stage callbacks on the
  executor.

``strict=True`` verifies every plan statically (``repro_torch.analysis``)
and refuses an ERROR-level one before anything runs; ``hook=`` is the
fault-injection point (``repro_torch.dist.chaos``), called before every
instruction on the pipeline's stage threads and before each micro-batch
on the sequential path. The process backend
(:class:`repro_torch.dist.cluster.ProcessBackend`) is not built here: it
needs a live cluster coordinator, and ``RunnerConfig.fault_domain=
"process"`` routes through the cluster. The mesh backend (ROADMAP A13) is
not ported: :func:`make_backend` raises ``NotImplementedError`` for it and
never runs something else in its place.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import (PipelineExecutor, StageCallbacks,
                                      reject_bad_plan)
from repro_torch.core.instructions import ExecutionPlan, Instr, Op
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.pipeline_adapter import (EncDecPipelinedModel,
                                                PipelinedModel,
                                                build_encdec_grad_step,
                                                build_grad_step,
                                                model_cache_namespace)
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import add_into


@dataclass
class BackendResult:
    """What executing one replica's plan produced.

    ``timings`` entries are ``(kind, mb_id, seconds)`` with ``kind`` one of
    ``"f"``/``"b"`` (a stage's forward or backward, pipeline) or
    ``"total"`` (the micro-batch's forward and backward, sequential path).
    """
    grads: Any
    loss_sum: float
    weight_sum: float
    timings: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)


class ExecutionBackend:
    """Protocol of the execution planes: ``execute_plan(plan, *, params,
    batches, callbacks=None, hook=None, collect_timings=False,
    timeout=None) -> BackendResult`` runs one replica's plan;
    :meth:`place_opt_state` / :meth:`optimizer_step` own the optimizer's
    layout (the default: one device, eager AdamW)."""

    name = "abstract"

    def execute_plan(self, plan: ExecutionPlan, *, params=None, batches=None,
                     callbacks=None, hook=None, collect_timings: bool = False,
                     timeout: Optional[float] = None) -> BackendResult:
        raise NotImplementedError

    def place_opt_state(self, opt_state):
        return opt_state

    def optimizer_step(self, params, grads, opt_state, opt_cfg):
        return adamw_update(params, grads, opt_state, opt_cfg)


def _timed_callbacks(cbs: list[StageCallbacks], records: list, lock,
                     streams: Optional[list]):
    """Wrap every stage's forward and backward with wall timers that stop
    once the stage's work is done on the card (an event on the stage's
    stream, synchronised), not when it was queued. Records ``("f" | "b",
    mb_id, seconds)`` under ``lock``: callbacks run on stage threads."""
    def wrap(j, cb: StageCallbacks) -> StageCallbacks:
        def timed(kind, fn):
            def run(mb_id, *a):
                t0 = time.perf_counter()
                out = fn(mb_id, *a)
                if streams is not None:
                    ev = torch.cuda.Event()
                    ev.record(streams[j])
                    ev.synchronize()
                with lock:
                    records.append((kind, mb_id, time.perf_counter() - t0))
                return out
            return run
        return StageCallbacks(timed("f", cb.forward), timed("b", cb.backward),
                              cb.step)
    return [wrap(j, cb) for j, cb in enumerate(cbs)]


class ThreadsBackend(ExecutionBackend):
    """Host plane: the threaded stage pipeline, or sequential accumulation
    (see the module docstring for which), on ``device``."""

    name = "threads"

    def __init__(self, cfg: ArchConfig, n_stages: int,
                 step_cache: Optional[CompiledStepCache] = None, *,
                 use_executor: bool = True, exec_timeout: float = 120.0,
                 strict: bool = False, device="cuda"):
        self.cfg = cfg
        self.n_stages = n_stages
        self.step_cache = step_cache if step_cache is not None \
            else CompiledStepCache()
        self.exec_timeout = exec_timeout
        self.strict = strict
        self.device = torch.device(device)
        if cfg.family == "encdec":
            # total periods = enc + dec; a stage must also not straddle
            # the enc/dec boundary
            total = 2 * cfg.n_periods
            pipelined = (use_executor and n_stages > 1
                         and total % n_stages == 0
                         and cfg.n_periods % (total // n_stages) == 0)
            model = EncDecPipelinedModel
        else:
            pipelined = (use_executor and n_stages > 1
                         and cfg.n_periods % n_stages == 0)
            model = PipelinedModel
        self.pm = (model(cfg, None, n_stages, step_cache=self.step_cache)
                   if pipelined else None)
        if pipelined and self.device.type == "cuda":
            # built here, not inside a stage thread on the executor's clock
            from repro_torch.kernels import _build
            for name in ("flash_fwd", "flash_bwd"):
                _build.library(name)

    def _grad_fn(self, shape: tuple):
        """shape: (mbs, seq) decoder-only or (mbs, enc, dec) enc-dec."""
        key = ("grad", model_cache_namespace(self.cfg)) + shape
        build = build_encdec_grad_step if len(shape) == 3 else build_grad_step
        return self.step_cache.get(key, lambda: build(self.cfg))

    @staticmethod
    def _batch_shape(b) -> tuple:
        if "enc_tokens" in b:
            return (int(b["enc_tokens"].shape[0]),
                    int(b["enc_tokens"].shape[1]),
                    int(b["dec_tokens"].shape[1]))
        return int(b["tokens"].shape[0]), int(b["tokens"].shape[1])

    def execute_plan(self, plan: ExecutionPlan, *, params=None, batches=None,
                     callbacks=None, hook=None, collect_timings: bool = False,
                     timeout: Optional[float] = None) -> BackendResult:
        timeout = timeout if timeout is not None else self.exec_timeout
        if self.strict:
            reject_bad_plan(plan, "ThreadsBackend")
        if callbacks is not None:
            # raw host-plane mode: the caller owns the stage callbacks
            PipelineExecutor(plan, callbacks, timeout=timeout,
                             hook=hook).run()
            return BackendResult(None, 0.0, 0.0)
        if not plan.micro_batches:
            return BackendResult(None, 0.0, 0.0)

        if self.pm is not None:
            pm = self.pm
            pm.set_params(params)
            cbs, result = pm.make_callbacks(plan, batches)
            records: list = []
            if collect_timings:
                cbs = _timed_callbacks(cbs, records, threading.Lock(),
                                       pm.streams)
            try:
                PipelineExecutor(plan, cbs, timeout=timeout, hook=hook).run()
            finally:
                # also when a stage failed (an injected fault raised on one
                # stage thread aborts the others): kernels the other stages
                # queued may still run on their streams, and a retry must
                # not reuse their memory before they end. The failed
                # attempt's stage gradients die with its ``result``; the
                # retry's callbacks start from none.
                pm.join_streams()
            grads = pm.merge_stage_grads(result["stage_grads"])
            return BackendResult(grads, result["loss_sum"],
                                 result["weight_sum"], records)

        grads, loss_sum, w_sum = None, 0.0, 0.0
        timings: list = []
        for mb_id in sorted(batches):
            if hook is not None:
                # no stage threads here: one stage-0 forward per
                # micro-batch, so stage-0 faults and stragglers fire as on
                # the pipeline
                hook(0, Instr(Op.FORWARD, mb_id))
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
                 use_executor: bool = True, exec_timeout: float = 120.0,
                 strict: bool = False, device="cuda") -> ExecutionBackend:
    """Backend factory keyed by ``RunnerConfig.backend``."""
    if name == "threads":
        return ThreadsBackend(cfg, n_stages, step_cache=step_cache,
                              use_executor=use_executor,
                              exec_timeout=exec_timeout, strict=strict,
                              device=device)
    if name == "mesh":
        raise NotImplementedError(
            "the mesh backend is not ported yet (ROADMAP A13)")
    if name == "process":
        raise ValueError(
            "the process backend is not built by the factory: it needs a "
            "live cluster coordinator (sockets, membership, election) — "
            "set RunnerConfig.fault_domain='process' and the runner routes "
            "through repro_torch.dist.cluster.run_process_cluster instead")
    raise ValueError(f"unknown execution backend {name!r}; "
                     "expected 'threads' or 'mesh'")

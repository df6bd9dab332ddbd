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
"process"`` routes through the cluster.

:class:`MeshBackend` is the device plane: a plan's micro-batches, grouped
by shape, ride the forward and backward shift register of
:func:`repro_torch.dist.pipeline.pipelined_grads` over a stage mesh
(:func:`repro_torch.launch.mesh.make_stage_mesh`), one process driving
the mesh's devices, in the plan's injection order; ZeRO-1 splits the
optimizer state over the stages (:meth:`MeshBackend.place_opt_state`,
:meth:`MeshBackend.optimizer_step`).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import (PipelineExecutor, StageCallbacks,
                                      reject_bad_plan)
from repro_torch.core.instructions import ExecutionPlan, Instr, Op
from repro_torch.dist.pipeline import (injection_order, pipelined_grads,
                                       stage_devices)
from repro_torch.dist.sharding import (Mesh, ZeroShards, spec_for_zero,
                                       zero1_logical)
from repro_torch.train import optimizer as TO
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.pipeline_adapter import (EncDecPipelinedModel,
                                                PipelinedModel, _stage_apply,
                                                _stage_bwd_step,
                                                _stage_fwd_step,
                                                build_encdec_grad_step,
                                                build_grad_step,
                                                model_cache_namespace,
                                                stage_slice)
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import add_into, leaves, tree_map


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
            _build.preload(cfg)

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
            with tracing.span("h2d"):
                # a pageable copy: the host waits for it
                tracing.count("sync", len(batches[mb_id]))
                b = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batches[mb_id].items()}
            t0 = time.perf_counter()
            ls, ws, g = self._grad_fn(self._batch_shape(b))(params, b)
            with tracing.span("sync"):
                # float() syncs: t0..here is real compute
                tracing.count("sync", 2)
                loss_sum += float(ls)
                w_sum += float(ws)
            if collect_timings:
                timings.append(("total", mb_id, time.perf_counter() - t0))
            grads = g if grads is None else add_into(grads, g)
            del g
        return BackendResult(grads, loss_sum, w_sum, timings)


_BATCH_KEYS = ("tokens", "labels", "loss_weights", "positions",
               "segment_ids")


class MeshBackend(ExecutionBackend):
    """Device plane: each shape group of a plan runs the forward and
    backward shift register over the stage mesh.

    Decoder-only token models, as in the reference: the enc-dec ``(he,
    hd)`` payload and the other input modes stay on the threads backend
    (``NotImplementedError``). The mesh defaults to
    ``make_stage_mesh(n_stages)`` on the card, or ``n_stages`` times
    ``device`` when that is not a CUDA device; a mesh given names its
    devices, which may repeat one card. Its first axis is the stage axis;
    any further axes hold replicas of each stage, as in the reference, and
    stage ``s`` runs on the first device of its row
    (``pipeline.stage_devices``).

    Each stage runs the threaded pipeline's stage steps (``_stage_apply``:
    stage 0 embeds, the last norms and takes the loss; a backward
    recomputes its stage from the stashed input), cached under ``("mesh",
    namespace, mbs, seq)``. The reference pads a group's micro-batch
    count to a power of two to bound XLA's recompiles; the eager port runs
    no filler micro-batch, so ``meta["groups"]``' ``m_pad`` is the real
    count. Per-micro-batch losses are summed on the host in ascending
    ``mb_id``, as the threads backend's sequential path does, so a
    1-stage mesh gives its loss to the bit.

    ``params`` passed to :meth:`execute_plan` is the whole tree, on one
    device; stage ``s`` computes with its slice on ``mesh`` device ``s``
    (no copy where the slice is there already), and the gradients come
    back as one whole tree on the params' device.
    """

    name = "mesh"

    def __init__(self, cfg: ArchConfig, n_stages: int,
                 step_cache: Optional[CompiledStepCache] = None, *,
                 mesh: Optional[Mesh] = None, strict: bool = False,
                 device="cuda"):
        self.strict = strict
        if cfg.family == "encdec":
            raise NotImplementedError(
                "MeshBackend runs decoder-only models; the enc-dec pipeline "
                "executes on the threads backend (backend='threads')")
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                f"MeshBackend supports input_mode='tokens' "
                f"(got {cfg.input_mode!r})")
        if cfg.n_periods % n_stages:
            raise ValueError(
                f"{cfg.name}: n_periods {cfg.n_periods} not divisible by "
                f"{n_stages} stages")
        if mesh is None:
            from repro_torch.launch.mesh import make_stage_mesh
            device = torch.device(device)
            mesh = make_stage_mesh(
                n_stages, devices=(None if device.type == "cuda"
                                   else [device] * n_stages))
        self.cfg = cfg
        self.n_stages = n_stages
        self.mesh = mesh
        self.devices = stage_devices(mesh, n_stages)
        self.k = cfg.n_periods // n_stages
        self.step_cache = step_cache if step_cache is not None \
            else CompiledStepCache()
        # model identity and mesh identity: a shared cache never hands one
        # mesh's steps to another
        self._ns = (model_cache_namespace(cfg), n_stages,
                    tuple(str(d) for d in self.devices))
        if any(d.type == "cuda" for d in self.devices):
            # built here, not on the first iteration's clock
            from repro_torch.kernels import _build
            _build.preload(cfg)

    # ------------------------- param placement -------------------------
    def _place_params(self, params) -> list:
        """Stage ``s``'s slice of ``params`` on its device: the ``(k, …)``
        period slice of the stack, and the shared tensors it uses; no copy
        where a tensor is on that device already."""
        return [tree_map(lambda x, d=d: x.to(d),
                         stage_slice(self.cfg, params, self.n_stages, s))
                for s, d in enumerate(self.devices)]

    def _group_step(self, mbs: int, seq: int) -> list:
        """Per stage, its ``(forward, backward)`` steps for ``(mbs, seq)``
        micro-batches."""
        cfg, S, k = self.cfg, self.n_stages, self.k

        def build():
            static = (cfg, k, S)
            return [(_stage_fwd_step(_stage_apply, static, s),
                     _stage_bwd_step(_stage_apply, static, s, s == S - 1))
                    for s in range(S)]
        return self.step_cache.get(("mesh", *self._ns, mbs, seq), build)

    def _merge(self, stage_grads: list, params):
        """Per-stage gradient trees -> one tree of ``params``' structure on
        the params' device: each stack slice copied into its place, a
        shared tensor's contributions (the tied embedding) summed in
        ascending stage order on stage 0's device."""
        dev = leaves(params)[0].device
        k = self.k
        stack = tree_map(torch.empty_like, params["stack"])
        shared: dict = {}
        for s, g in enumerate(stage_grads):
            tree_map(lambda dst, src, s=s: dst[s * k:(s + 1) * k].copy_(src),
                     stack, g["stack"])
            for key, val in g.items():
                if key == "stack":
                    continue
                val = val.to(self.devices[0])
                shared[key] = val if key not in shared \
                    else shared[key].add_(val)
        out = {key: val.to(dev) for key, val in shared.items()}
        out["stack"] = stack
        return out

    def _sync(self):
        for i in sorted({d.index or 0 for d in self.devices
                         if d.type == "cuda"}):
            torch.cuda.synchronize(i)

    # ------------------------- plan execution --------------------------
    def execute_plan(self, plan: ExecutionPlan, *, params=None, batches=None,
                     callbacks=None, hook=None, collect_timings: bool = False,
                     timeout: Optional[float] = None) -> BackendResult:
        if self.strict:
            reject_bad_plan(plan, "MeshBackend")
        if callbacks is not None:
            raise ValueError(
                "the mesh backend runs plans as shift registers over the "
                "stage mesh; callback-driven execution is the threads "
                "backend's host plane (backend='threads')")
        if not plan.micro_batches:
            return BackendResult(None, 0.0, 0.0)
        order = injection_order(plan)
        ids = sorted(m.mb_id for m in plan.micro_batches)
        if sorted(order) != ids:
            raise ValueError("plan injection order does not cover its "
                             "micro-batches")
        if hook is not None:
            # one stage-0 forward event per micro-batch, in ring order, so
            # chaos schedules fire as on the host plane
            for mb_id in order:
                hook(0, Instr(Op.FORWARD, mb_id))

        # shape groups in first-appearance ring order; within a group the
        # micro-batches keep the injection order, the ring's hand-off order
        groups: dict[tuple, list[int]] = {}
        for mb_id in order:
            b = batches[mb_id]
            shape = (int(b["tokens"].shape[0]), int(b["tokens"].shape[1]))
            groups.setdefault(shape, []).append(mb_id)

        stage_params = self._place_params(params)
        loss_by_mb: dict[int, float] = {}
        w_by_mb: dict[int, float] = {}
        grads = None
        timings: list = []
        meta: dict = {"groups": []}
        for (mbs, seq), members in groups.items():
            steps = self._group_step(mbs, seq)
            bstack = [{key: torch.as_tensor(batches[i][key])
                       for key in _BATCH_KEYS} for i in members]
            t0 = time.perf_counter()
            lv, wv, stage_grads = pipelined_grads(
                steps, stage_params, bstack, mesh=self.mesh,
                n_stages=self.n_stages)
            lv = torch.stack(lv).tolist()      # syncs the last stage
            wv = torch.stack(wv).tolist()
            g = self._merge(stage_grads, params)
            del stage_grads
            if collect_timings:
                self._sync()
                dt = time.perf_counter() - t0
                timings.extend(("total", mb_id, dt / len(members))
                               for mb_id in members)
            for pos, mb_id in enumerate(members):
                loss_by_mb[mb_id] = lv[pos]
                w_by_mb[mb_id] = wv[pos]
            grads = g if grads is None else add_into(grads, g)
            del g
            meta["groups"].append({"mbs": mbs, "seq": seq,
                                   "n_micro": len(members),
                                   "m_pad": len(members)})

        # ascending mb_id, as the threads backend's sequential path sums
        loss_sum = 0.0
        w_sum = 0.0
        for mb_id in ids:
            loss_sum += loss_by_mb[mb_id]
            w_sum += w_by_mb[mb_id]
        return BackendResult(grads, loss_sum, w_sum, timings, meta)

    # ---------------------- ZeRO-1 optimizer layer ---------------------
    def place_opt_state(self, opt_state):
        """ZeRO-1: split every optimizer-state leaf over the stages along
        the dim ``zero1_logical`` picks (the largest the stage count
        divides), chunk ``s`` on stage ``s``'s device; a leaf no dim
        divides, and the ``step`` count, stay whole. On a ``("stage",
        "model")`` mesh ``zero`` resolves to the stage axis alone (never to
        a model axis), so a stage's replicas share its chunk, as in the
        reference. The dicts are updated
        in place (each whole leaf is freed once its chunks exist) and
        returned; a leaf placed already is left as it is."""
        mesh, S = self.mesh, self.n_stages

        def place(x):
            if not isinstance(x, torch.Tensor) or x.ndim == 0:
                return x
            zl = zero1_logical((None,) * x.ndim, tuple(x.shape), mesh)
            spec = spec_for_zero(tuple(x.shape), zl, mesh)
            if not len(spec):
                return x
            dim = next(i for i, e in enumerate(spec) if e is not None)
            n = x.shape[dim] // S
            return ZeroShards(
                [x.narrow(dim, s * n, n).to(d, copy=True,
                                            memory_format=torch.
                                            contiguous_format)
                 for s, d in enumerate(self.devices)], dim)

        def walk(tree):
            for key, val in tree.items():
                tree[key] = walk(val) if isinstance(val, dict) else place(val)
            return tree
        return walk(opt_state)

    def optimizer_step(self, params, grads, opt_state, opt_cfg):
        """AdamW with the state as :meth:`place_opt_state` left it: the
        global norm of the whole gradients (``train/optimizer.py``'s), then
        each chunk of (master, m, v) updated on its device from its slice
        of the gradient, and the new bf16 params written into their slice
        of ``params``. Every update is elementwise, so the result equals
        ``adamw_update`` on the unplaced state to the bit."""
        gnorm, scale, step, b1c, b2c = TO.step_scalars(grads, opt_state,
                                                       opt_cfg)
        for p, g, m, v, ma in zip(leaves(params), leaves(grads),
                                  leaves(opt_state["m"]),
                                  leaves(opt_state["v"]),
                                  leaves(opt_state["master"])):
            if not isinstance(m, ZeroShards):
                TO._update_leaf(p, g, m, v, ma, scale, b1c, b2c, opt_cfg)
                continue
            for s, (mc, vc, mac) in enumerate(zip(m.chunks, v.chunks,
                                                  ma.chunks)):
                sl = m.bounds(s)
                TO._update_leaf(None, g.narrow(*sl).to(mc.device), mc, vc,
                                mac, scale.to(mc.device), b1c, b2c, opt_cfg)
                p.narrow(*sl).copy_(mac)
        opt_state["step"] = step
        return params, opt_state, {"grad_norm": gnorm}


def make_backend(name: str, cfg: ArchConfig, n_stages: int, *,
                 step_cache: Optional[CompiledStepCache] = None,
                 use_executor: bool = True, exec_timeout: float = 120.0,
                 mesh: Optional[Mesh] = None, strict: bool = False,
                 device="cuda") -> ExecutionBackend:
    """Backend factory keyed by ``RunnerConfig.backend``; ``mesh`` is the
    mesh backend's stage mesh (see :class:`MeshBackend` for its
    default)."""
    if name == "threads":
        return ThreadsBackend(cfg, n_stages, step_cache=step_cache,
                              use_executor=use_executor,
                              exec_timeout=exec_timeout, strict=strict,
                              device=device)
    if name == "mesh":
        return MeshBackend(cfg, n_stages, step_cache=step_cache, mesh=mesh,
                           strict=strict, device=device)
    if name == "process":
        raise ValueError(
            "the process backend is not built by the factory: it needs a "
            "live cluster coordinator (sockets, membership, election) — "
            "set RunnerConfig.fault_domain='process' and the runner routes "
            "through repro_torch.dist.cluster.run_process_cluster instead")
    raise ValueError(f"unknown execution backend {name!r}; "
                     "expected 'threads' or 'mesh'")

"""Plan-ahead runtime: double-buffered planning over deterministic streams.

Counterpart of ``repro.train.runner``. While iteration *k* executes, a
``PlannerPool`` already plans iteration *k+1* (dp_split -> adaptive
schedule -> comm plan -> instruction lowering), so planning stays off the
critical path; ``synchronous=True`` plans inline instead, and both execute
identical plans over identical batches, so their trajectories are equal
bit for bit.

Per iteration, every replica's plan runs on ``RunnerConfig.device``
through the backend ``RunnerConfig.backend`` names: ``"threads"``, the
threaded stage pipeline when ``use_executor`` and the periods split over
the planner's stages, else the sequential grad loop; or ``"mesh"``, the
shift register over a stage mesh (``mesh=``, by default the backend's)
with ZeRO-1 optimizer state (attention through the CUDA kernels K1 and
the fused backward on the card, either way). The gradients are summed in
place, scaled by 1 / (loss weight sum) and AdamW updates the params in
place. A checkpoint holds each optimizer leaf whole; a restore reads it
back into the backend's placement. An
encoder-decoder config (``family == "encdec"``) starts from
``init_encdec`` and runs 2-D ``(enc, dec)`` micro-batches; its stream must
give every sample a decoder target.

Fault tolerance, as in the reference: the loop survives the fault classes
of :mod:`repro_torch.dist.chaos`. A failed iteration (a ``PipelineError``
from the executor, or an ``InjectedFault`` on the sequential path) is
retried up to ``max_retries`` times: in-flight plans are drained and the
stream replanned, and when the fault lost the state (``state_lost``)
params and optimizer state are restored in place from the newest valid
checkpoint and the stream replayed from its step; since the kernels repeat
bit for bit, the replayed trajectory equals the fault-free one to the bit.
Planner futures that time out or break are resubmitted; a replica that
stops heartbeating triggers an :class:`ElasticPlanManager` sweep that
shrinks ``dp_size`` to the survivors. ``strict_verify`` has the backend
verify every plan before it runs. Checkpoints are written every
``ckpt_every`` iterations and restored at start; anything that escapes the
loop leaves an emergency checkpoint, unless it escaped from inside the
in-place optimizer update (see :meth:`PlanAheadRunner.run`).

``fault_domain="process"`` hands the whole run to
:func:`repro_torch.dist.cluster.run_process_cluster`: one OS process per DP
replica, a socket coordinator doing the planning, and real SIGKILL chaos.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import CostModel, OnlineCalibrator
from repro_torch.core.executor import PipelineError
from repro_torch.core.instructions import ExecutionPlan, InstructionStore
from repro_torch.core.planner import PlannerConfig, PlannerPool, plan_iteration
from repro_torch.data.dataset import materialize_micro_batch
from repro_torch.data.streams import GlobalBatch
from repro_torch.device import resolve_device
from repro_torch.dist.backend import ExecutionBackend, make_backend
from repro_torch.dist.chaos import FaultSchedule, InjectedFault, LogicalClock
from repro_torch.dist.fault import (ElasticPlanManager, StragglerMonitor,
                                    make_planner_replan)
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import add_into, leaves


@dataclass
class RunnerConfig:
    """The run configuration: the reference's fields, plus ``device``,
    without ``impl`` (the port dispatches by device)."""
    n_iters: int = 50
    backend: str = "threads"         # "threads" | "mesh"
    lookahead: int = 1               # plans kept in flight ahead of execution
    synchronous: bool = False        # plan inline (fallback / bitwise oracle)
    use_processes: bool = False      # PlannerPool backend (core/planner.py)
    use_executor: bool = True        # threaded pipeline vs sequential accum
    global_tokens: int = 4096        # tokens per global batch (loop entry)
    log_every: int = 10
    ckpt_every: int = 0              # 0 = off
    ckpt_dir: str = ""
    seed: int = 0
    plan_timeout: float = 300.0
    exec_timeout: float = 120.0      # executor rendezvous timeout (s)
    # ------------------------ fault tolerance --------------------------
    max_retries: int = 2             # per-iteration retry budget on faults
    retry_backoff_s: float = 0.05    # base backoff between retries
    drift_tolerance: float = 1.2     # apply measured speed factors to plans
                                     # only past this slowest/fastest ratio
    calibrate: bool = False          # online cost-model calibration
    strict_verify: bool = False      # the backend verifies each plan and
                                     # refuses an ERROR-level one
    fault_domain: str = "thread"     # "thread": in-process (chaos hooks);
                                     # "process": dist/cluster.py
    device: str = "cuda"             # where params, batches and steps live


class DatasetStream:
    """Adapter: stateful ``MultiTaskDataset`` -> the stream protocol.

    Batches are generated in ascending iteration order on first request and
    cached, so plan-ahead requests for k+1 before k executes are consistent.
    """

    def __init__(self, dataset, samples_per_batch: int, vocab: int):
        self.dataset = dataset
        self.samples_per_batch = samples_per_batch
        self.vocab = vocab
        self._cache: dict[int, GlobalBatch] = {}
        self._next = 0
        self._min_live = 0

    def batch(self, iteration: int) -> GlobalBatch:
        if iteration < self._min_live:
            raise ValueError(
                f"batch {iteration} was evicted (oldest live: "
                f"{self._min_live}); DatasetStream hands out each batch "
                "once, in ascending order — use MultiTaskStream for "
                "random access")
        while self._next <= iteration:
            lengths, tokens, tids = self.dataset.sample_minibatch(
                self.samples_per_batch, self.vocab)
            self._cache[self._next] = GlobalBatch(
                iteration=self._next, lengths=lengths,
                task_ids=np.asarray(tids, dtype=np.int64), tokens=tokens)
            self._next += 1
        gb = self._cache[iteration]
        for it in [i for i in self._cache if i < iteration]:
            del self._cache[it]
        self._min_live = iteration
        return gb


@dataclass
class RunnerStats:
    iters: int = 0
    planning_s: float = 0.0          # total planner CPU seconds (workers)
    plan_wait_s: float = 0.0         # total main-loop seconds blocked on plans
    exec_s: float = 0.0              # total iteration wall seconds
    real_tokens: int = 0
    padded_tokens: int = 0
    overlap_planning_s: float = 0.0  # planning_s over overlappable iters (>1st)
    overlap_wait_s: float = 0.0      # plan_wait_s over the same iters
    cache: dict = field(default_factory=dict)
    mode: str = "plan-ahead"
    faults: int = 0                  # faults observed (exec + planner)
    recovery_s: float = 0.0          # wall seconds spent in recovery paths
    recoveries: list = field(default_factory=list)   # event dicts
    calibration: dict = field(default_factory=dict)  # OnlineCalibrator summary
    cluster: dict = field(default_factory=dict)      # (process domain)
    # one dict per checkpoint written or restored: kind "save" (step,
    # bytes, sync_s, d2h_s, crc_s, write_s) or "load" (step, bytes, load_s)
    checkpoints: list = field(default_factory=list)

    @property
    def overlap_fraction(self) -> float:
        """Share of planning work hidden behind execution (first iteration
        excluded — there is nothing to overlap the primed plan with)."""
        if self.overlap_planning_s <= 0:
            return 0.0
        hidden = self.overlap_planning_s - self.overlap_wait_s
        return max(0.0, min(1.0, hidden / self.overlap_planning_s))


def scale_(tree, scale: float):
    """Multiply every leaf by ``scale``, in place."""
    for x in leaves(tree):
        x.mul_(scale)


def _injected_event(err: BaseException):
    """Walk the cause chain for an InjectedFault; returns its FaultEvent."""
    seen = set()
    e: Optional[BaseException] = err
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, InjectedFault):
            return e.event
        e = e.__cause__ or e.__context__
    return None


class PlanAheadRunner:
    """Drives training with planning double-buffered ahead of execution.

    ``params`` (optional) is the initial parameter tree on
    ``rcfg.device``, which the runner trains in place; by default it draws
    one from a ``torch.Generator`` seeded with ``rcfg.seed``. ``mesh`` is
    the stage mesh of ``backend="mesh"``. ``monitor``
    (a :class:`StragglerMonitor`) receives each replica's iteration time
    and drives elastic replanning; ``chaos`` (a :class:`FaultSchedule`)
    injects faults. After :meth:`run`, ``opt_state`` holds the final
    optimizer state.
    """

    def __init__(self, cfg: ArchConfig, cost: CostModel, pcfg: PlannerConfig,
                 rcfg: RunnerConfig, stream,
                 opt_cfg: Optional[AdamWConfig] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 step_cache: Optional[CompiledStepCache] = None,
                 chaos: Optional[FaultSchedule] = None, mesh=None,
                 params=None):
        if rcfg.fault_domain == "process" and params is not None:
            raise ValueError(
                "params= seeds the in-process runner; the process fault "
                "domain's workers each draw theirs from rcfg.seed")
        self.device = resolve_device(rcfg.device)
        self.cfg = cfg
        self.cost = cost
        self.pcfg = pcfg
        self.rcfg = rcfg
        self.stream = stream
        self.params = params
        self.mesh = mesh                 # stage mesh for backend="mesh"
        self.backend: Optional[ExecutionBackend] = None  # built in run()
        self.opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig(lr=3e-4)
        self.monitor = monitor
        self.chaos = chaos
        self.step_cache = step_cache if step_cache is not None \
            else CompiledStepCache()
        self.store = InstructionStore()
        self.pool: Optional[PlannerPool] = None
        self._pending: dict[int, GlobalBatch] = {}
        self._futures: dict = {}
        # positions in the alive list <-> original replica ids; shrinks on
        # replica death (ElasticPlanManager sweep)
        self._alive: list[int] = list(range(max(1, pcfg.dp_size)))
        self.elastic = (ElasticPlanManager(monitor,
                                           make_planner_replan(cost, pcfg))
                        if monitor is not None else None)
        self._calibrator = (OnlineCalibrator(cost)
                            if rcfg.calibrate else None)
        self._end = 0
        self.opt_state = None

    # ------------------------- planning side ---------------------------
    @staticmethod
    def _plan_lengths(gb: GlobalBatch):
        L = gb.lengths
        return L[:, 0] if not np.any(L[:, 1]) else L

    def _pcfg_now(self) -> PlannerConfig:
        p = self.pcfg
        if self.monitor is not None and p.dp_size > 1 \
                and self.monitor.drift() > self.rcfg.drift_tolerance:
            # past the drift tolerance the imbalance is a straggler, not
            # timing noise: bake the measured factors into the next plan
            all_sf = self.monitor.speed_factors()
            sf = [all_sf[r] if r < len(all_sf) else 1.0
                  for r in self._alive]
            sf = (sf + [1.0] * p.dp_size)[:p.dp_size]
            p = dataclasses.replace(p, speed_factors=sf)
        return p

    def _submit(self, it: int) -> None:
        gb = self.stream.batch(it)
        self._pending[it] = gb
        fut = self.pool.submit(
            it, self._plan_lengths(gb), self.cost, self._pcfg_now())
        if self.chaos is not None:
            ev = self.chaos.take_planner_fault(it)
            if ev is not None:
                # the real submission still runs (its store push is
                # idempotent); the future the main loop sees is corrupted
                # (crash) or lost (never completes): _obtain recovers
                fut = cf.Future()
                if ev.kind.value == "planner_crash":
                    fut.set_exception(InjectedFault(ev))
        self._futures[it] = fut

    def _reset_pool(self) -> None:
        if self.pool is not None:
            with contextlib.suppress(Exception):
                self.pool.shutdown()
        self.pool = PlannerPool(
            self.store, n_workers=max(2, self.rcfg.lookahead + 1),
            use_processes=self.rcfg.use_processes)

    def _obtain(self, it: int, stats: Optional[RunnerStats] = None):
        """Returns (global_batch, replica-0 plan, IterationPlan, wait_s,
        planning_s). Planner faults (timeout, crashed or lost future,
        broken pool) resubmit with backoff instead of killing the run; a
        lost future costs ``plan_timeout``."""
        rcfg = self.rcfg
        if rcfg.synchronous:
            gb = self.stream.batch(it)
            with tracing.timed("plan_wait") as waited:
                if self.chaos is not None:
                    ev = self.chaos.take_planner_fault(it)
                    if ev is not None and stats is not None:
                        # inline planning: a dead planner is just run again
                        stats.faults += 1
                        stats.recoveries.append(
                            {"iter": it, "kind": "planner_replanned",
                             "fault": ev.describe()})
                it_plan = plan_iteration(self._plan_lengths(gb), self.cost,
                                         self._pcfg_now())
                self.store.push(it, it_plan.replica_plans[0])
                plan = self.store.fetch(it, timeout=rcfg.plan_timeout)
        else:
            gb = self._pending.pop(it)
            with tracing.timed("plan_wait") as waited:
                it_plan = None
                for attempt in range(rcfg.max_retries + 1):
                    fut = self._futures.pop(it)
                    try:
                        it_plan = fut.result(timeout=rcfg.plan_timeout)
                        break
                    except (TimeoutError, cf.TimeoutError, cf.CancelledError,
                            cf.BrokenExecutor, InjectedFault) as e:
                        if attempt >= rcfg.max_retries:
                            raise PipelineError(
                                f"plan for iteration {it} failed after "
                                f"{attempt + 1} attempts: {e!r}") from e
                        if stats is not None:
                            stats.faults += 1
                            stats.recoveries.append(
                                {"iter": it, "kind": "planner_resubmit",
                                 "fault": repr(e)})
                        if isinstance(e, cf.BrokenExecutor):
                            self._reset_pool()
                        time.sleep(rcfg.retry_backoff_s * (attempt + 1))
                        self._submit(it)
                        self._pending.pop(it, None)  # gb already in hand
                plan = self.store.fetch(it, timeout=rcfg.plan_timeout)
        self.store.evict_below(it)  # executed plans are dead; keep RSS flat
        return gb, plan, it_plan, waited.seconds, it_plan.planning_seconds

    # ------------------------- execution side --------------------------
    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def _execute_replica(self, it: int, rep: int, plan: ExecutionPlan,
                         gb: GlobalBatch, params):
        """One replica's plan -> (grads, loss_sum, weight_sum)."""
        if not plan.micro_batches:
            return None, 0.0, 0.0   # idle replica (fewer micro-batches than dp)
        with tracing.span("materialise"):
            batches = {m.mb_id: materialize_micro_batch(
                           m, gb.tokens, lengths=gb.lengths)
                       for m in plan.micro_batches}
        hook = (self.chaos.executor_hook(it, replica=rep)
                if self.chaos is not None else None)
        res = self.backend.execute_plan(
            plan, params=params, batches=batches, hook=hook,
            collect_timings=self._calibrator is not None,
            timeout=self.rcfg.exec_timeout)
        if self._calibrator is not None and res.timings:
            by_id = {m.mb_id: m for m in plan.micro_batches}
            for kind, mb_id, secs in res.timings:
                m = by_id[mb_id]
                seq = (tuple(m.seq) if isinstance(m.seq, (tuple, list))
                       else m.seq)
                if kind == "f":
                    self._calibrator.observe(m.mbs, seq, fwd_s=secs)
                elif kind == "b":
                    self._calibrator.observe(m.mbs, seq, bwd_s=secs)
                else:
                    self._calibrator.observe_total(m.mbs, seq, secs)
        return res.grads, res.loss_sum, res.weight_sum

    # ------------------------- recovery side ---------------------------
    def _drain(self) -> None:
        """Cancel in-flight plans and forget buffered state: they were
        made under a topology or speed assumption that just died."""
        if self.pool is not None:
            self.pool.drain()
        for fut in self._futures.values():
            fut.cancel()
        self._futures.clear()
        self._pending.clear()
        self.store.clear()

    def _resubmit_window(self, it: int) -> None:
        if self.rcfg.synchronous or self.pool is None:
            return
        for i in range(it, min(it + max(1, self.rcfg.lookahead), self._end)):
            if i not in self._futures:
                self._submit(i)

    def _topology_sweep(self, it: int, stats: RunnerStats) -> None:
        """The replica set changed: run an ElasticPlanManager sweep, shrink
        (or re-grow) ``dp_size`` to the survivors, drain and resubmit."""
        gb = self.stream.batch(it)
        res = self.elastic.plan(self._plan_lengths(gb))
        alive = res["alive"]
        if not alive:
            raise PipelineError(f"iteration {it}: all replicas dead")
        self._alive = list(alive)
        self.pcfg = dataclasses.replace(
            self.pcfg, dp_size=len(alive),
            speed_factors=list(res["speed_factors"]))
        if self.elastic.replan is not None:
            # later sweeps replan under the surviving topology
            self.elastic.replan = make_planner_replan(self.cost, self.pcfg)
        stats.faults += len(res["dead_this_sweep"])
        stats.recoveries.append({
            "iter": it, "kind": "replica_set_change",
            "alive": list(alive), "dead": list(res["dead"]),
            "dead_this_sweep": list(res["dead_this_sweep"]),
            "recovered_this_sweep": list(res["recovered_this_sweep"]),
        })
        self._drain()
        self._resubmit_window(it)

    def _recover(self, it: int, err: BaseException, params, opt,
                 stats: RunnerStats):
        """Post-fault path: drain, maybe restore, replan. Returns
        (params, opt, resume_iteration). A restore copies the checkpoint
        into the live tensors; a step that fails to load leaves them
        untouched, so the fallback retries with the state in memory."""
        self._drain()
        resume = it
        ev = _injected_event(err)
        if ev is not None and ev.state_lost and self.rcfg.ckpt_dir:
            try:
                timings: dict = {}
                state, manifest = CKPT.load_latest_valid(
                    self.rcfg.ckpt_dir, {"params": params, "opt": opt},
                    timings)
                params, opt = state["params"], state["opt"]
                if self.backend is not None:
                    opt = self.backend.place_opt_state(opt)
                resume = int(manifest["step"])
                stats.checkpoints.append(
                    {"kind": "load", "step": resume, **timings})
                stats.recoveries.append(
                    {"iter": it, "kind": "checkpoint_restore",
                     "restored_step": resume, "fault": repr(err)})
            except FileNotFoundError:
                warnings.warn(
                    f"iteration {it}: state lost but no restorable "
                    "checkpoint — retrying with in-memory params",
                    stacklevel=2)
                stats.recoveries.append(
                    {"iter": it, "kind": "retry_no_checkpoint",
                     "fault": repr(err)})
        else:
            stats.recoveries.append(
                {"iter": it, "kind": "retry", "fault": repr(err)})
        time.sleep(self.rcfg.retry_backoff_s)
        self._resubmit_window(resume)
        return params, opt, resume

    def _save(self, step: int, params, opt, stats: RunnerStats,
              extra: Optional[dict] = None) -> None:
        timings: dict = {}
        CKPT.save(self.rcfg.ckpt_dir, step, {"params": params, "opt": opt},
                  extra=extra, timings=timings)
        stats.checkpoints.append({"kind": "save", "step": step, **timings})

    def _emergency_save(self, params, opt, stats: RunnerStats) -> None:
        """Best-effort final checkpoint before the run dies; it never masks
        the original failure. After a sticky CUDA error the save's own
        device synchronise raises too: that is warned about, and the
        original exception goes on.

        The step is the optimizer's own count of committed updates, not the
        loop's iteration: between an iteration's update and the loop's
        ``it += 1`` (the heartbeats, the history, the periodic save) the
        state already holds iteration ``it``'s update, and a checkpoint
        labelled ``it`` would replay that iteration a second time on
        restart."""
        if not self.rcfg.ckpt_dir:
            return
        step = opt["step"]
        try:
            self._save(step, params, opt, stats, extra={"emergency": True})
        except Exception as e:   # noqa: BLE001 — reporting path
            warnings.warn(f"emergency checkpoint at step {step} "
                          f"failed: {e!r}", stacklevel=2)

    # ------------------------------ run --------------------------------
    def run(self):
        """Returns (params, history, stats: RunnerStats)."""
        if self.rcfg.fault_domain == "process":
            # the process fault domain replaces this whole in-process loop:
            # one OS process per DP replica, a socket coordinator doing the
            # planning, and real SIGKILL chaos delivered by the launcher
            from repro_torch.dist.cluster import run_process_cluster
            return run_process_cluster(
                self.cfg, self.cost, self.pcfg, self.rcfg, self.stream,
                opt_cfg=self.opt_cfg, chaos=self.chaos)
        rcfg, cfg = self.rcfg, self.cfg
        params = self.params
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(rcfg.seed)
            init = T.init_encdec if self._encdec else MD.init_params
            params = init(gen, cfg, device=self.device)
        opt = init_opt_state(params, self.opt_cfg)
        stats = RunnerStats(
            mode="synchronous" if rcfg.synchronous else "plan-ahead")
        start = 0
        if rcfg.ckpt_dir:
            timings: dict = {}
            state, start = CKPT.restore_or_init(
                rcfg.ckpt_dir, lambda: {"params": params, "opt": opt},
                timings)
            if start:
                params, opt = state["params"], state["opt"]
                stats.checkpoints.append(
                    {"kind": "load", "step": start, **timings})

        self.backend = make_backend(
            rcfg.backend, cfg, self.pcfg.n_stages, step_cache=self.step_cache,
            use_executor=rcfg.use_executor, exec_timeout=rcfg.exec_timeout,
            mesh=self.mesh, strict=rcfg.strict_verify, device=self.device)
        opt = self.backend.place_opt_state(opt)

        end = start + rcfg.n_iters
        self._end = end
        if not rcfg.synchronous:
            self._reset_pool()
            for i in range(start, min(start + rcfg.lookahead, end)):
                self._submit(i)

        history = []
        it = start
        attempts = 0
        # True while AdamW overwrites params, master, m and v leaf by leaf:
        # unlike the reference's pure update, an exception escaping from
        # inside it (an OOM, a CUDA error, an interrupt) leaves some leaves
        # at step k + 1 and the rest at step k. No checkpoint is written
        # from such a state: one labelled k holding part of k + 1 would
        # restore silently wrong.
        updating = False
        try:
            while it < end:
                tracing.iteration(it)
                with tracing.timed("iteration") as whole:
                    try:
                        if self.elastic is not None \
                                and self.monitor.alive() != self._alive:
                            t_rec = time.perf_counter()
                            self._topology_sweep(it, stats)
                            stats.recovery_s += time.perf_counter() - t_rec
                        ahead = it + rcfg.lookahead
                        if not rcfg.synchronous and ahead < end \
                                and ahead not in self._futures:
                            self._submit(ahead)
                        gb, plan, it_plan, wait_s, planning_s = \
                            self._obtain(it, stats)
                        if self._encdec and any(
                                not isinstance(m.seq, (tuple, list))
                                for m in plan.micro_batches):
                            raise ValueError(
                                "enc-dec model got a decoder-only "
                                "micro-batch: the stream must carry (enc, "
                                "dec) lengths with dec > 0 for every sample "
                                "(use encdec_fraction=1.0)")
                        # every surviving replica's plan executes here (one
                        # process stands in for the DP group) and the grads
                        # merge, so the full-batch gradient does not depend
                        # on the split
                        grads, loss_sum, w_sum = None, 0.0, 0.0
                        replica_s: dict[int, float] = {}
                        for pos, rplan in enumerate(it_plan.replica_plans):
                            rep = (self._alive[pos] if pos < len(self._alive)
                                   else pos)
                            # replica 0 executes the store-roundtripped plan;
                            # others roundtrip locally for identical semantics
                            xplan = plan if pos == 0 else \
                                ExecutionPlan.from_json(rplan.to_json())
                            rt0 = time.perf_counter()
                            g, ls, ws = self._execute_replica(
                                it, rep, xplan, gb, params)
                            if self.monitor is not None \
                                    and self.device.type == "cuda":
                                # the pipeline's join only makes this stream
                                # wait on the stages: end the replica's time
                                # when its work has run, not when queued
                                with tracing.span("sync"):
                                    tracing.count("sync")
                                    torch.cuda.synchronize(self.device)
                            replica_s[rep] = time.perf_counter() - rt0
                            loss_sum += ls
                            w_sum += ws
                            if g is not None:
                                grads = (g if grads is None
                                         else add_into(grads, g))
                    except (PipelineError, InjectedFault) as e:
                        stats.faults += 1
                        attempts += 1
                        if attempts > rcfg.max_retries:
                            # retry budget spent: the handler below writes the
                            # emergency checkpoint
                            raise
                        t_rec = time.perf_counter()
                        params, opt, it = self._recover(it, e, params, opt,
                                                        stats)
                        stats.recovery_s += time.perf_counter() - t_rec
                        continue
                    attempts = 0

                    scale_(grads, 1.0 / max(w_sum, 1.0))
                    updating = True
                    params, opt, om = self.backend.optimizer_step(
                        params, grads, opt, self.opt_cfg)
                    updating = False
                    with tracing.span("sync"):
                        tracing.count("sync")
                        grad_norm = float(om["grad_norm"])
                    del grads
                dt = whole.seconds
                if self.monitor is not None:
                    for rep in self._alive:
                        if self.chaos is not None \
                                and self.chaos.replica_silent(it, rep):
                            continue
                        self.monitor.heartbeat(
                            rep, iter_time=replica_s.get(rep, dt))
                    if isinstance(self.monitor.clock, LogicalClock):
                        self.monitor.clock.advance(1.0)

                padded = sum(
                    m.mbs * (sum(m.seq) if isinstance(m.seq, (tuple, list))
                             else m.seq)
                    for rp in it_plan.replica_plans
                    for m in rp.micro_batches)
                n_micro = sum(len(rp.micro_batches)
                              for rp in it_plan.replica_plans)
                loss = loss_sum / max(w_sum, 1.0)
                history.append({
                    "iter": it, "loss": loss, "time_s": dt,
                    "n_micro": n_micro, "grad_norm": grad_norm,
                    "plan_wait_s": wait_s, "planning_s": planning_s,
                    "tokens": gb.total_tokens, "padded_tokens": int(padded),
                })
                stats.iters += 1
                stats.planning_s += planning_s
                stats.plan_wait_s += wait_s
                stats.exec_s += dt
                stats.real_tokens += gb.total_tokens
                stats.padded_tokens += int(padded)
                if it > start:
                    stats.overlap_planning_s += planning_s
                    stats.overlap_wait_s += wait_s

                if rcfg.log_every and it % rcfg.log_every == 0:
                    print(f"iter {it:5d}  loss {loss:8.4f}  micro-batches "
                          f"{n_micro:3d}  {dt*1e3:7.1f} ms  "
                          f"plan-wait {wait_s*1e3:6.1f} ms", flush=True)
                if rcfg.ckpt_dir and rcfg.ckpt_every \
                        and (it + 1) % rcfg.ckpt_every == 0:
                    self._save(it + 1, params, opt, stats)
                it += 1
        except BaseException:
            if updating:
                warnings.warn(
                    f"iteration {it}: the failure escaped from inside the "
                    "in-place optimizer update, which leaves the state part "
                    f"at step {it + 1} and part at step {it}; no emergency "
                    "checkpoint is written", stacklevel=2)
            else:
                # anything else that escapes the retry loop (retries
                # spent included) leaves a final restart point
                self._emergency_save(params, opt, stats)
            raise
        finally:
            if self.pool is not None:
                self.pool.shutdown()
                self.pool = None
        stats.cache = self.step_cache.stats()
        if self._calibrator is not None:
            stats.calibration = self._calibrator.summary()
        self.opt_state = opt
        return params, history, stats

"""Plan-ahead runtime: double-buffered planning over deterministic streams.

Counterpart of ``repro.train.runner`` on the threads backend. While
iteration *k* executes, a ``PlannerPool`` already plans iteration *k+1*
(dp_split -> adaptive schedule -> comm plan -> instruction lowering), so
planning stays off the critical path; ``synchronous=True`` plans inline
instead, and both execute identical plans over identical batches, so their
trajectories are equal bit for bit.

Per iteration, every replica's plan runs on ``RunnerConfig.device``
through the threads backend: the threaded stage pipeline when
``use_executor`` and the periods split over the planner's stages, else the
sequential grad loop (attention through the CUDA kernels K1 and the fused
backward on the card). The gradients are summed in place, scaled by
1 / (loss weight sum) and AdamW updates the params in place. An
encoder-decoder config (``family == "encdec"``) starts from
``init_encdec`` and runs 2-D ``(enc, dec)`` micro-batches; its stream must
give every sample a decoder target.

A failed plan (a planner future that times out or breaks) or a failed
iteration (a ``PipelineError`` from the executor) is replanned and
retried up to ``max_retries`` times, as in the reference. What the
reference adds around that is not ported yet and raises
``NotImplementedError`` when asked for: strict plan verification (ROADMAP
A4), checkpoints (A10), fault injection and the straggler monitor (A12),
the mesh backend (A13) and the process fault domain (A14).
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import CostModel, OnlineCalibrator
from repro_torch.core.executor import PipelineError
from repro_torch.core.instructions import ExecutionPlan, InstructionStore
from repro_torch.core.planner import PlannerConfig, PlannerPool, plan_iteration
from repro_torch.data.dataset import materialize_micro_batch
from repro_torch.data.streams import GlobalBatch
from repro_torch.device import resolve_device
from repro_torch.dist.backend import ExecutionBackend, make_backend
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import add_into, leaves


@dataclass
class RunnerConfig:
    """The run configuration: the reference's fields, plus ``device``,
    without ``impl`` (the port dispatches by device) and
    ``drift_tolerance`` (no straggler monitor yet)."""
    n_iters: int = 50
    backend: str = "threads"         # "threads" ("mesh": not ported)
    lookahead: int = 1               # plans kept in flight ahead of execution
    synchronous: bool = False        # plan inline (fallback / bitwise oracle)
    use_processes: bool = False      # PlannerPool backend (core/planner.py)
    use_executor: bool = True        # threaded pipeline vs sequential accum
    global_tokens: int = 4096        # tokens per global batch (loop entry)
    log_every: int = 10
    ckpt_every: int = 0              # 0 = off (checkpoints: not ported)
    ckpt_dir: str = ""
    seed: int = 0
    plan_timeout: float = 300.0
    exec_timeout: float = 120.0      # executor rendezvous timeout (s)
    # ------------------------ fault tolerance --------------------------
    max_retries: int = 2             # per-iteration retry budget on faults
    retry_backoff_s: float = 0.05    # base backoff between retries
    calibrate: bool = False          # online cost-model calibration
    strict_verify: bool = False      # verify each plan (not ported)
    fault_domain: str = "thread"     # ("process": not ported)
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

    @property
    def overlap_fraction(self) -> float:
        """Share of planning work hidden behind execution (first iteration
        excluded — there is nothing to overlap the primed plan with)."""
        if self.overlap_planning_s <= 0:
            return 0.0
        hidden = self.overlap_planning_s - self.overlap_wait_s
        return max(0.0, min(1.0, hidden / self.overlap_planning_s))

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "iters": self.iters,
            "planning_s": round(self.planning_s, 4),
            "plan_wait_s": round(self.plan_wait_s, 4),
            "exec_s": round(self.exec_s, 4),
            "real_tokens": self.real_tokens,
            "padded_tokens": self.padded_tokens,
            "overlap_fraction": round(self.overlap_fraction, 4),
            "cache": dict(self.cache),
            "faults": self.faults,
            "n_recoveries": len(self.recoveries),
            "recovery_s": round(self.recovery_s, 4),
            "recoveries": list(self.recoveries),
            "calibration": dict(self.calibration),
            "cluster": dict(self.cluster),
        }


def scale_(tree, scale: float):
    """Multiply every leaf by ``scale``, in place."""
    for x in leaves(tree):
        x.mul_(scale)


class PlanAheadRunner:
    """Drives training with planning double-buffered ahead of execution.

    ``params`` (optional) is the initial parameter tree on
    ``rcfg.device``, which the runner trains in place; by default it draws
    one from a ``torch.Generator`` seeded with ``rcfg.seed``.
    """

    def __init__(self, cfg: ArchConfig, cost: CostModel, pcfg: PlannerConfig,
                 rcfg: RunnerConfig, stream,
                 opt_cfg: Optional[AdamWConfig] = None,
                 monitor=None, step_cache: Optional[CompiledStepCache] = None,
                 chaos=None, mesh=None, params=None):
        unported = {
            "strict plan verification (strict_verify)": "A4",
            "checkpoints (ckpt_dir / ckpt_every)": "A10",
            "fault injection (chaos)": "A12",
            "the straggler monitor": "A12",
            "the mesh backend": "A13",
            "the process fault domain": "A14",
        }
        asked = [rcfg.strict_verify, rcfg.ckpt_dir or rcfg.ckpt_every,
                 chaos is not None, monitor is not None,
                 rcfg.backend == "mesh" or mesh is not None,
                 rcfg.fault_domain == "process"]
        for (what, item), on in zip(unported.items(), asked):
            if on:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})")
        self.device = resolve_device(rcfg.device)
        self.cfg = cfg
        self.cost = cost
        self.pcfg = pcfg
        self.rcfg = rcfg
        self.stream = stream
        self.params = params
        self.backend: Optional[ExecutionBackend] = None  # built in run()
        self.opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig(lr=3e-4)
        self.step_cache = step_cache if step_cache is not None \
            else CompiledStepCache()
        self.store = InstructionStore()
        self.pool: Optional[PlannerPool] = None
        self._pending: dict[int, GlobalBatch] = {}
        self._futures: dict = {}
        self._calibrator = (OnlineCalibrator(cost)
                            if rcfg.calibrate else None)
        self._end = 0

    # ------------------------- planning side ---------------------------
    @staticmethod
    def _plan_lengths(gb: GlobalBatch):
        L = gb.lengths
        return L[:, 0] if not np.any(L[:, 1]) else L

    def _submit(self, it: int) -> None:
        gb = self.stream.batch(it)
        self._pending[it] = gb
        self._futures[it] = self.pool.submit(
            it, self._plan_lengths(gb), self.cost, self.pcfg)

    def _reset_pool(self) -> None:
        if self.pool is not None:
            with contextlib.suppress(Exception):
                self.pool.shutdown()
        self.pool = PlannerPool(
            self.store, n_workers=max(2, self.rcfg.lookahead + 1),
            use_processes=self.rcfg.use_processes)

    def _obtain(self, it: int, stats: Optional[RunnerStats] = None):
        """Returns (global_batch, replica-0 plan, IterationPlan, wait_s,
        planning_s). A planner future that times out or breaks is
        resubmitted with backoff instead of killing the run."""
        rcfg = self.rcfg
        if rcfg.synchronous:
            gb = self.stream.batch(it)
            t0 = time.perf_counter()
            it_plan = plan_iteration(self._plan_lengths(gb), self.cost,
                                     self.pcfg)
            self.store.push(it, it_plan.replica_plans[0])
            plan = self.store.fetch(it, timeout=rcfg.plan_timeout)
            wait = time.perf_counter() - t0
        else:
            gb = self._pending.pop(it)
            t0 = time.perf_counter()
            it_plan = None
            for attempt in range(rcfg.max_retries + 1):
                fut = self._futures.pop(it)
                try:
                    it_plan = fut.result(timeout=rcfg.plan_timeout)
                    break
                except (TimeoutError, cf.TimeoutError, cf.CancelledError,
                        cf.BrokenExecutor) as e:
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
            wait = time.perf_counter() - t0
        self.store.evict_below(it)  # executed plans are dead; keep RSS flat
        return gb, plan, it_plan, wait, it_plan.planning_seconds

    # ------------------------- execution side --------------------------
    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def _execute_replica(self, plan: ExecutionPlan, gb: GlobalBatch, params):
        """One replica's plan -> (grads, loss_sum, weight_sum)."""
        if not plan.micro_batches:
            return None, 0.0, 0.0   # idle replica (fewer micro-batches than dp)
        batches = {m.mb_id: materialize_micro_batch(
                       m, gb.tokens, lengths=gb.lengths)
                   for m in plan.micro_batches}
        res = self.backend.execute_plan(
            plan, params=params, batches=batches,
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
        """Cancel in-flight plans and forget buffered state."""
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

    def _recover(self, it: int, err: BaseException, stats: RunnerStats):
        """Post-fault path: drain, replan, retry the iteration with the
        params in memory (nothing was applied: the update comes last)."""
        self._drain()
        stats.recoveries.append({"iter": it, "kind": "retry",
                                 "fault": repr(err)})
        time.sleep(self.rcfg.retry_backoff_s)
        self._resubmit_window(it)

    # ------------------------------ run --------------------------------
    def run(self):
        """Returns (params, history, stats: RunnerStats)."""
        rcfg, cfg = self.rcfg, self.cfg
        params = self.params
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(rcfg.seed)
            init = T.init_encdec if self._encdec else MD.init_params
            params = init(gen, cfg, device=self.device)
        opt = init_opt_state(params, self.opt_cfg)

        self.backend = make_backend(
            rcfg.backend, cfg, self.pcfg.n_stages, step_cache=self.step_cache,
            use_executor=rcfg.use_executor, exec_timeout=rcfg.exec_timeout,
            strict=rcfg.strict_verify, device=self.device)
        opt = self.backend.place_opt_state(opt)

        start, end = 0, rcfg.n_iters
        self._end = end
        if not rcfg.synchronous:
            self._reset_pool()
            for i in range(start, min(start + rcfg.lookahead, end)):
                self._submit(i)

        history = []
        stats = RunnerStats(
            mode="synchronous" if rcfg.synchronous else "plan-ahead")
        it = start
        attempts = 0
        try:
            while it < end:
                t0 = time.perf_counter()
                try:
                    if not rcfg.synchronous and it + rcfg.lookahead < end \
                            and (it + rcfg.lookahead) not in self._futures:
                        self._submit(it + rcfg.lookahead)
                    gb, plan, it_plan, wait_s, planning_s = \
                        self._obtain(it, stats)
                    if self._encdec and any(
                            not isinstance(m.seq, (tuple, list))
                            for m in plan.micro_batches):
                        raise ValueError(
                            "enc-dec model got a decoder-only micro-batch: "
                            "the stream must carry (enc, dec) lengths with "
                            "dec > 0 for every sample (use "
                            "encdec_fraction=1.0)")
                    # every replica's plan executes here (one process stands
                    # in for the DP group) and the grads merge, so the
                    # full-batch gradient does not depend on the split
                    grads, loss_sum, w_sum = None, 0.0, 0.0
                    for pos, rplan in enumerate(it_plan.replica_plans):
                        # replica 0 executes the store-roundtripped plan;
                        # others roundtrip locally for identical semantics
                        xplan = plan if pos == 0 else \
                            ExecutionPlan.from_json(rplan.to_json())
                        g, ls, ws = self._execute_replica(xplan, gb, params)
                        loss_sum += ls
                        w_sum += ws
                        if g is not None:
                            grads = g if grads is None else add_into(grads, g)
                except PipelineError as e:
                    stats.faults += 1
                    attempts += 1
                    if attempts > rcfg.max_retries:
                        raise
                    t_rec = time.perf_counter()
                    self._recover(it, e, stats)
                    stats.recovery_s += time.perf_counter() - t_rec
                    continue
                attempts = 0

                scale_(grads, 1.0 / max(w_sum, 1.0))
                params, opt, om = self.backend.optimizer_step(
                    params, grads, opt, self.opt_cfg)
                grad_norm = float(om["grad_norm"])   # syncs the device
                del grads
                dt = time.perf_counter() - t0

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
                it += 1
        finally:
            if self.pool is not None:
                self.pool.shutdown()
                self.pool = None
        stats.cache = self.step_cache.stats()
        if self._calibrator is not None:
            stats.calibration = self._calibrator.summary()
        return params, history, stats

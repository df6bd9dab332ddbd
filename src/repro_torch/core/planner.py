"""End-to-end iteration planner (paper §3 "Planners").

One call = one training iteration:

  mini-batch lengths
    -> order_samples                         (§4)
    -> dp_split (Eq. 1/2, memory-capped)     (§4)
    -> balance_replicas (Karmarkar–Karp)     (§4)
    -> cluster_permute injection order       (§5)
    -> schedule_adaptive (Alg. 1) or 1F1B    (§5)
    -> simulate -> build_instructions        (§6)
    -> ExecutionPlan (+ predicted makespan / memory / padding stats)

Planning is pure CPU work; ``PlannerPool`` overlaps it with execution by
planning iteration k+1 on worker threads while k runs (paper §3/§8.5), and
supports elastic re-planning when the replica set changes (dist/fault.py).
"""
from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import comm_plan, microbatch, schedule as sched
from repro_torch.core.cost_model import CostModel
from repro_torch.core.instructions import (ExecutionPlan, InstructionStore,
                                     MicroBatchSpec, RecomputePolicy)
from repro_torch.core.recompute import choose_recompute, cost_model_for
from repro_torch.core.shapes import ShapePalette
from repro_torch.core.simulator import simulate


@dataclass
class PlannerConfig:
    n_stages: int
    dp_size: int = 1
    device_mem: float = 16e9
    schedule: str = "adaptive"           # adaptive | 1f1b
    ordering: str = "sort"               # sort | tsp
    n_clusters: int = 3
    palette: Optional[ShapePalette] = None
    t_max_interval: float = 5e-6
    comm_latency: float = 0.0
    d_model: int = 0
    dynamic_recompute: bool = False
    speed_factors: Optional[list[float]] = None
    mem_limit_factor: Optional[float] = None   # per-micro-batch DP cap
    # opt-in static verification (repro_torch.analysis) of every replica plan.
    # Runs inside plan_iteration, i.e. on PlannerPool workers — off the
    # execution critical path behind the planner overlap. ERROR-level
    # findings raise PlanVerificationError; the findings summary is
    # recorded in plan.meta["verification"] either way.
    verify_plans: bool = False


@dataclass
class IterationPlan:
    replica_plans: list[ExecutionPlan]
    ordering: np.ndarray
    micro_batches: list[microbatch.MicroBatch]
    padding_efficiency: float
    predicted_iteration_time: float
    planning_seconds: float


def _mb_specs(mbs: list[microbatch.MicroBatch], order: np.ndarray,
              bwd_mult: float = 1.0) -> list[MicroBatchSpec]:
    out = []
    for mb_id, m in enumerate(mbs):
        out.append(MicroBatchSpec(
            mb_id=mb_id,
            sample_indices=[int(order[i]) for i in m.indices],
            mbs=m.mbs, seq=m.seq, t_fwd=m.t_fwd, t_bwd=m.t_bwd * bwd_mult,
            mem=m.mem))
    return out


def plan_replica(
    mbs: list[microbatch.MicroBatch],
    order: np.ndarray,
    pcfg: PlannerConfig,
    recompute: RecomputePolicy = RecomputePolicy.FULL,
) -> ExecutionPlan:
    """Schedule + comm-plan one replica's micro-batches."""
    c = pcfg.n_stages
    specs = _mb_specs(mbs, order)
    n_micro = len(specs)
    if n_micro == 0:
        # legitimately empty: fewer micro-batches than replicas this
        # iteration (tiny batch, or a near-zero speed factor starved the
        # replica) — an idle replica executes nothing, not a crash
        return ExecutionPlan(
            n_stages=c, micro_batches=[], per_stage=[[] for _ in range(c)],
            recompute=recompute, predicted_makespan=0.0,
            predicted_peak_mem=[0.0] * c, meta={"injection_order": []})
    tf = np.array([[m.t_fwd / c] * c for m in specs])
    tb = np.array([[m.t_bwd / c] * c for m in specs])
    am = np.array([[m.mem / c] * c for m in specs])

    if pcfg.schedule == "1f1b":
        dev_order = sched.schedule_1f1b(n_micro, c)
        inj = list(range(n_micro))
    else:
        lim = pcfg.device_mem  # adaptive schedule enforces the cap itself

        def evaluate(order_ids):
            o = sched.schedule_adaptive(n_micro, c, am, lim,
                                        injection_order=list(order_ids))
            return simulate(o, tf, tb, act_mem=am,
                            comm_latency=pcfg.comm_latency).makespan

        inj = sched.cluster_permute_order(
            [m.t_fwd + m.t_bwd for m in specs], pcfg.n_clusters,
            evaluate=evaluate if n_micro <= 64 else None)
        dev_order = sched.schedule_adaptive(n_micro, c, am, lim,
                                            injection_order=inj)

    sim = simulate(dev_order, tf, tb, act_mem=am, comm_latency=pcfg.comm_latency)
    streams = comm_plan.build_instructions(dev_order, specs, sim,
                                           d_model=pcfg.d_model)
    assert not comm_plan.check_order_consistency(streams)
    return ExecutionPlan(
        n_stages=c,
        micro_batches=specs,
        per_stage=streams,
        recompute=recompute,
        predicted_makespan=sim.makespan,
        predicted_peak_mem=sim.peak_mem,
        meta={"injection_order": list(map(int, inj))},
    )


def plan_iteration(lengths, cost: CostModel, pcfg: PlannerConfig,
                   recompute: RecomputePolicy = RecomputePolicy.FULL) -> IterationPlan:
    t0 = time.perf_counter()
    order = microbatch.order_samples(lengths, pcfg.ordering)
    L = microbatch._as2d(lengths)[order]
    mem_factor = pcfg.mem_limit_factor
    if mem_factor is None:
        # 1F1B pins up to c in-flight micro-batches; adaptive enforces its own
        # cap, so allow bigger micro-batches (paper §4: factors 1/c .. 1).
        mem_factor = (1.0 / pcfg.n_stages if pcfg.schedule == "1f1b"
                      else 2.0 / pcfg.n_stages)
    mbs = microbatch.dp_split(
        L, cost, pcfg.n_stages,
        mem_limit=pcfg.device_mem * mem_factor,
        dp_size=pcfg.dp_size, palette=pcfg.palette,
        t_max_interval=pcfg.t_max_interval)
    groups = microbatch.balance_replicas(mbs, pcfg.dp_size, pcfg.speed_factors)
    plans = [plan_replica(g, order, pcfg, recompute) for g in groups]
    if pcfg.verify_plans:
        # deferred import: repro_torch.analysis depends on core, not vice versa
        from repro_torch.analysis import PlanVerificationError, verify_plan
        for r, p in enumerate(plans):
            report = verify_plan(p, palette=pcfg.palette,
                                 mem_limit=pcfg.device_mem)
            d = report.to_dict()
            p.meta["verification"] = {"worst": d["worst"],
                                      "counts": d["counts"]}
            if report.errors:
                raise PlanVerificationError(
                    f"replica {r} plan failed static verification", report)
    t_iter = max(p.predicted_makespan for p in plans)
    return IterationPlan(
        replica_plans=plans,
        ordering=order,
        micro_batches=mbs,
        padding_efficiency=microbatch.padding_efficiency(mbs, L),
        predicted_iteration_time=t_iter,
        planning_seconds=time.perf_counter() - t0,
    )


def plan_iteration_dynamic_recompute(lengths, cfg, pcfg: PlannerConfig):
    """Paper §7: re-plan under each recompute policy, keep fastest that fits."""
    def under(policy: RecomputePolicy):
        cm = cost_model_for(cfg, pcfg.n_stages, policy)
        it = plan_iteration(lengths, cm, pcfg, recompute=policy)
        # surface a single ExecutionPlan-like facade for choose_recompute
        plan = it.replica_plans[0]
        plan.predicted_makespan = it.predicted_iteration_time
        plan.meta["iteration_plan"] = it
        return plan
    best = choose_recompute(under, pcfg.device_mem)
    return best.meta["iteration_plan"]


def _plan_job(lengths, cost, pcfg: PlannerConfig) -> IterationPlan:
    """Module-level so ProcessPoolExecutor can pickle the work item."""
    return plan_iteration(lengths, cost, pcfg)


class PlannerPool:
    """Overlaps plan generation with execution (paper §3): a worker pool
    plans future iterations ahead of the executor and pushes them to the
    instruction store.

    Backends:

    - threads (default) — zero-copy submission and a shared in-process
      group-cost LUT, but the numpy/Python DP holds the GIL, so concurrent
      planning barely scales beyond ~1 effective core. Fine when one
      iteration's plan comfortably fits inside one iteration's execution.
    - processes (``use_processes=True``) — true CPU parallelism across
      iterations (the paper overlaps planning on up to 13 cores, §8.5), at
      the cost of pickling ``(lengths, cost, pcfg)`` per submission and a
      cold per-process LUT. Cost models and planner configs must be
      picklable (`AnalyticCostModel`, `ProfiledCostModel`, and
      `cost_model_for` products are; see tests/test_planning_fastpath.py).
      Workers are spawned, not forked — importing ``repro`` loads jax, and
      forking a multithreaded jax parent risks deadlock — so worker startup
      pays one interpreter+import per process; the pool is long-lived, so
      that cost amortizes across the training run.
    """

    def __init__(self, store: InstructionStore, n_workers: int = 4,
                 use_processes: bool = False):
        self.store = store
        self.use_processes = use_processes
        self.pool: cf.Executor
        if use_processes:
            self.pool = cf.ProcessPoolExecutor(
                max_workers=n_workers,
                mp_context=multiprocessing.get_context("spawn"))
        else:
            self.pool = cf.ThreadPoolExecutor(max_workers=n_workers)
        self.futures: dict[int, cf.Future] = {}

    def submit(self, iteration: int, lengths, cost, pcfg: PlannerConfig):
        inner = self.pool.submit(_plan_job, lengths, cost, pcfg)
        # chain a parent-side future that also covers the store.push, so a
        # failing push surfaces through .result() instead of being swallowed
        # by the done-callback machinery
        outer: cf.Future = cf.Future()

        def _push(fut: cf.Future):
            if fut.cancelled():
                outer.cancel()
                return
            exc = fut.exception()
            if exc is not None:
                outer.set_exception(exc)
                return
            try:
                it_plan = fut.result()
                # replica 0's plan is fetched by every stage executor of
                # replica 0 etc.
                self.store.push(iteration, it_plan.replica_plans[0])
                outer.set_result(it_plan)
            except BaseException as e:      # noqa: BLE001 — must not vanish
                outer.set_exception(e)

        inner.add_done_callback(_push)
        self.futures[iteration] = outer
        return outer

    def discard(self, iteration: int) -> None:
        """Forget (and best-effort cancel) the tracked future for one
        iteration; the recovery path resubmits it afterwards."""
        fut = self.futures.pop(iteration, None)
        if fut is not None:
            fut.cancel()

    def drain(self) -> None:
        """Cancel and forget every outstanding submission (fault recovery:
        in-flight plans were made under a stale topology). Already-running
        jobs finish in the background; their pushes are harmlessly
        overwritten when the iterations are resubmitted."""
        for it in list(self.futures):
            self.discard(it)

    def shutdown(self):
        self.pool.shutdown(wait=True)

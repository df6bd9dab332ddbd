"""Deterministic fault injection for the robustness loop (ISSUE 7).

A :class:`FaultSchedule` is a *replayable* trace of faults: a list of
:class:`FaultEvent` declaring, per iteration, what breaks and where. Tests
and ``benchmarks/bench_elastic.py`` build the same schedule (explicitly or
via :meth:`FaultSchedule.seeded`) and replay identical fault traces against
``PlanAheadRunner`` runs, so recovery behaviour — and the post-recovery loss
trajectory — is reproducible bit-for-bit given the trace.

Four fault classes, mirroring the failure modes a real multi-replica run
sees (paper §3: the planner is stateless per iteration, so every one of
these reduces to "drain, maybe restore, replan over the survivors"):

- ``STRAGGLER``    — delay one stage's compute instructions by ``delay_s``
  (injected via the executor's pre-instruction hook). No error is raised;
  the slow replica shows up in ``StragglerMonitor`` timings and, past the
  runner's drift tolerance, in the next plan's speed factors.
- ``STAGE_CRASH``  — raise :class:`InjectedFault` from a stage compute
  thread. Surfaces as a structured ``PipelineError``; with
  ``state_lost=True`` the runner must restore from the latest checkpoint
  before retrying (a worker process died and took its state with it).
- ``REPLICA_DEAD`` — suppress a replica's heartbeats from ``iteration``
  onward. The monitor declares it dead after its timeout and the runner
  re-plans the remaining stream over the survivors.
- ``PLANNER_CRASH`` / ``PLANNER_LOST`` — corrupt (raise from) or kill
  (never complete) one planner future. The runner must resubmit instead of
  dying on ``future.result``.
- ``KILL_PROCESS``  — (ISSUE 10) a *real* ``os.kill(pid, SIGKILL)``
  delivered by the process-cluster driver (:mod:`repro_torch.dist.cluster`) to a
  replica worker or the coordinator. Nothing is simulated: the target pid
  is verifiably dead afterwards (:func:`deliver_kill`), and recovery means
  surviving processes re-forming a smaller topology.

Injection is hook-based: nothing in the production path imports this module
unless a schedule is passed in, and every event fires **at most once** (the
schedule tracks fired events under a lock — executor hooks run on stage
threads).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, replace
from enum import Enum
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.instructions import (
    COMM_START_OPS,
    SEND_OPS,
    WAIT_OPS,
    ExecutionPlan,
    Op,
)


class FaultKind(str, Enum):
    STRAGGLER = "straggler"
    STAGE_CRASH = "stage_crash"
    REPLICA_DEAD = "replica_dead"
    PLANNER_CRASH = "planner_crash"
    PLANNER_LOST = "planner_lost"
    # real process death (ISSUE 10): the driver delivers os.kill(pid,
    # SIGKILL) to a replica worker or the coordinator of a process-domain
    # cluster (dist/cluster.py) — not simulated heartbeat silence
    KILL_PROCESS = "kill_process"


@dataclass(frozen=True)
class FaultEvent:
    """One declared fault. ``stage``/``op``/``micro_batch`` target executor
    faults (``micro_batch=-1`` fires on the first matching instruction);
    ``replica`` targets heartbeat suppression and per-replica stragglers;
    ``state_lost`` marks crashes the runner must checkpoint-restore from."""

    iteration: int
    kind: FaultKind
    stage: int = 0
    replica: int = 0
    delay_s: float = 0.05
    op: str = "F"                  # Op.value the executor hook fires on
    micro_batch: int = -1          # -1 = first matching instruction
    state_lost: bool = False
    target: str = "replica"        # KILL_PROCESS: "replica" | "coordinator"

    def describe(self) -> str:
        extra = ""
        if self.kind in (FaultKind.STRAGGLER, FaultKind.STAGE_CRASH):
            extra = f" stage={self.stage}"
        if self.kind == FaultKind.STRAGGLER:
            extra += f" delay={self.delay_s:g}s"
        if self.kind == FaultKind.REPLICA_DEAD:
            extra = f" replica={self.replica}"
        if self.kind == FaultKind.KILL_PROCESS:
            extra = (f" target={self.target}"
                     + (f" replica={self.replica}"
                        if self.target == "replica" else ""))
        if self.state_lost:
            extra += " state_lost"
        return f"{self.kind.value}@it{self.iteration}{extra}"


class InjectedFault(RuntimeError):
    """Raised by chaos hooks; carries the :class:`FaultEvent` that fired."""

    def __init__(self, event: FaultEvent):
        super().__init__(f"injected fault: {event.describe()}")
        self.event = event


class LogicalClock:
    """Injectable monotonic clock for :class:`StragglerMonitor`: one tick
    per runner iteration instead of wall seconds, so liveness timeouts are
    deterministic in tests and benches (``heartbeat_timeout`` is then
    measured in iterations)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def advance(self, dt: float = 1.0) -> None:
        self._t += dt

    def __call__(self) -> float:
        return self._t


class FaultSchedule:
    """A replayable, fire-once fault trace.

    ``executor_hook(iteration, replica)`` adapts the trace to the
    ``PipelineExecutor`` hook protocol; ``take_planner_fault`` and
    ``replica_silent`` are polled by the runner. ``log`` records every
    fired event as ``(iteration, event)`` for assertions and bench reports.
    """

    def __init__(self, events: Sequence[FaultEvent]):
        self.events = sorted(events, key=lambda e: (e.iteration, e.kind.value))
        self._fired: set[int] = set()
        self._lock = threading.Lock()
        self.log: list[FaultEvent] = []

    # ----------------------------- bookkeeping -------------------------
    def _take(self, idx: int) -> bool:
        """Atomically claim event ``idx``; False if already fired."""
        with self._lock:
            if idx in self._fired:
                return False
            self._fired.add(idx)
            self.log.append(self.events[idx])
            return True

    def pending(self) -> list[FaultEvent]:
        with self._lock:
            return [e for i, e in enumerate(self.events)
                    if i not in self._fired
                    and e.kind != FaultKind.REPLICA_DEAD]

    # ------------------------- executor injection ----------------------
    def executor_hook(self, iteration: int,
                      replica: int = 0) -> Optional[Callable]:
        """Pre-instruction hook for this (iteration, replica), or None.

        The returned callable matches ``PipelineExecutor``'s
        ``hook(stage, instr)`` protocol: it sleeps for ``STRAGGLER`` events
        and raises :class:`InjectedFault` for ``STAGE_CRASH`` events whose
        (stage, op, micro_batch) filter matches the instruction.
        """
        hits = [(i, e) for i, e in enumerate(self.events)
                if e.iteration == iteration and e.replica == replica
                and e.kind in (FaultKind.STRAGGLER, FaultKind.STAGE_CRASH)]
        if not hits:
            return None

        def hook(stage: int, instr) -> None:
            op = getattr(instr.op, "value", instr.op)
            for idx, ev in hits:
                if ev.stage != stage or ev.op != op:
                    continue
                if ev.micro_batch >= 0 and instr.micro_batch != ev.micro_batch:
                    continue
                if not self._take(idx):
                    continue
                if ev.kind == FaultKind.STRAGGLER:
                    time.sleep(ev.delay_s)
                else:
                    raise InjectedFault(ev)
        return hook

    # -------------------------- planner injection ----------------------
    def take_planner_fault(self, iteration: int) -> Optional[FaultEvent]:
        """Claim (at most once) a planner fault declared for ``iteration``."""
        for idx, ev in enumerate(self.events):
            if ev.iteration == iteration and ev.kind in (
                    FaultKind.PLANNER_CRASH, FaultKind.PLANNER_LOST):
                if self._take(idx):
                    return ev
        return None

    # --------------------------- process kills -------------------------
    def take_process_kills(self, iteration: int) -> list[FaultEvent]:
        """Claim (each at most once) every ``KILL_PROCESS`` event whose
        declared iteration has been reached. The cluster *driver* — the
        process supervising a ``dist/cluster.py`` run — polls this as
        training progresses and delivers each claimed event as a real
        ``os.kill(pid, SIGKILL)`` via :func:`deliver_kill`."""
        out = []
        for idx, ev in enumerate(self.events):
            if ev.kind == FaultKind.KILL_PROCESS \
                    and ev.iteration <= iteration and self._take(idx):
                out.append(ev)
        return out

    # ------------------------- heartbeat suppression -------------------
    def replica_silent(self, iteration: int, replica: int) -> bool:
        """True when ``replica`` must not heartbeat at ``iteration``
        (REPLICA_DEAD is persistent: dead from its iteration onward)."""
        for idx, ev in enumerate(self.events):
            if (ev.kind == FaultKind.REPLICA_DEAD and ev.replica == replica
                    and iteration >= ev.iteration):
                self._take(idx)  # record first suppression in the log
                return True
        return False

    # ------------------------------ factory ----------------------------
    @classmethod
    def seeded(cls, seed: int, n_iters: int, n_faults: int = 4,
               n_stages: int = 2, n_replicas: int = 2,
               kinds: Optional[Sequence[FaultKind]] = None,
               delay_s: float = 0.05) -> "FaultSchedule":
        """Deterministic random trace: ``n_faults`` events at distinct
        iterations in ``[1, n_iters)``, kinds cycled from ``kinds`` (default:
        one of each class). Same seed -> identical trace, any process."""
        rng = np.random.default_rng([int(seed), 0xC4A05])
        kinds = list(kinds) if kinds is not None else [
            FaultKind.STRAGGLER, FaultKind.PLANNER_LOST,
            FaultKind.STAGE_CRASH, FaultKind.REPLICA_DEAD]
        lo, hi = 1, max(2, n_iters)
        iters = sorted(rng.choice(np.arange(lo, hi),
                                  size=min(n_faults, hi - lo),
                                  replace=False).tolist())
        events = []
        for k, it in enumerate(iters):
            kind = kinds[k % len(kinds)]
            events.append(FaultEvent(
                iteration=int(it), kind=kind,
                stage=int(rng.integers(0, n_stages)),
                replica=(int(rng.integers(1, max(2, n_replicas)))
                         if kind == FaultKind.REPLICA_DEAD else 0),
                delay_s=delay_s,
                state_lost=bool(kind == FaultKind.STAGE_CRASH
                                and rng.random() < 0.5),
            ))
        return cls(events)

    def describe(self) -> list[str]:
        return [e.describe() for e in self.events]


def deliver_kill(pid: int, wait_s: float = 10.0) -> bool:
    """Deliver a real ``SIGKILL`` to ``pid`` and wait until the pid is a
    verified corpse (signal-0 probe raises ``ProcessLookupError``, or the
    pid is a zombie child awaiting reap — ``waitpid`` would collect it).

    Returns True when the process is verifiably dead within ``wait_s``.
    This is the KILL_PROCESS delivery path: unlike ``REPLICA_DEAD`` (which
    merely suppresses heartbeats in-process), the target is an actual OS
    process and its death is actual, observable kernel state.
    """
    import signal

    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        return True   # already dead
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        # reap if it is our child (direct kills from the cluster driver);
        # WNOHANG returns (0, 0) while the child still runs
        with contextlib.suppress(ChildProcessError, OSError):
            wpid, _ = os.waitpid(pid, os.WNOHANG)
            if wpid == pid:
                return True
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.01)
    return False


# ---------------------------------------------------------------------------
# Plan-mutation operators (the verifier's chaos corpus)
#
# Each operator seeds one *defect by construction* into an ExecutionPlan —
# the failure modes the static verifier (repro_torch.analysis) exists to catch.
# ``mutate_plan`` returns a mutated deep copy (via the plan's own JSON
# round trip, so mutants also exercise serialization) or None when the
# operator has no applicable site in the plan. The verifier must flag every
# mutant with at least one ERROR-level finding; the CLI's mutation corpus
# and check_regression.py gate that kill rate at 100%.
# ---------------------------------------------------------------------------

def _comm_sites(plan, ops) -> list:
    return [(j, idx) for j, stream in enumerate(plan.per_stage)
            for idx, ins in enumerate(stream) if ins.op in ops]


def _mut_drop_wait(plan, rng):
    """Remove one WAIT: the consuming compute op pops a missing buffer."""
    sites = _comm_sites(plan, WAIT_OPS)
    if not sites:
        return None
    j, idx = sites[int(rng.integers(len(sites)))]
    ins = plan.per_stage[j][idx]
    del plan.per_stage[j][idx]
    return f"dropped {ins.short()} at stage {j} #{idx}"


def _mut_swap_sends(plan, rng):
    """Swap two sends on one directed channel: the receiver still expects
    the original order — head-of-line deadlock on an in-order link."""
    by_channel = defaultdict(list)
    for j, idx in _comm_sites(plan, SEND_OPS):
        ins = plan.per_stage[j][idx]
        by_channel[(j, ins.peer)].append(idx)
    chans = [(ch, idxs) for ch, idxs in sorted(by_channel.items())
             if len(idxs) >= 2]
    if not chans:
        return None
    (j, peer), idxs = chans[int(rng.integers(len(chans)))]
    a, b = sorted(rng.choice(len(idxs), size=2, replace=False).tolist())
    ia, ib = idxs[a], idxs[b]
    st = plan.per_stage[j]
    st[ia], st[ib] = st[ib], st[ia]
    return (f"swapped {st[ib].short()} (#{ia}) with {st[ia].short()} "
            f"(#{ib}) on channel {j}->{peer}")


def _mut_corrupt_peer(plan, rng):
    """Re-point one comm Start at a wrong stage: its conjugate op now
    waits on a message that never arrives."""
    sites = _comm_sites(plan, COMM_START_OPS)
    if not sites or plan.n_stages < 2:
        return None
    j, idx = sites[int(rng.integers(len(sites)))]
    ins = plan.per_stage[j][idx]
    choices = [p for p in range(plan.n_stages) if p != ins.peer]
    peer = choices[int(rng.integers(len(choices)))]
    plan.per_stage[j][idx] = replace(ins, peer=peer)
    return (f"re-pointed {ins.short()} at stage {j} #{idx} to peer {peer}")


def _mut_inflate_shape(plan, rng):
    """Inflate one comm Start's tensor shape: the conjugate endpoint and
    the MicroBatchSpec disagree with it (ragged buffers at runtime)."""
    from dataclasses import replace

    from repro_torch.core.instructions import COMM_START_OPS
    sites = [(j, idx) for j, idx in _comm_sites(plan, COMM_START_OPS)
             if plan.per_stage[j][idx].shape is not None]
    if not sites:
        return None
    j, idx = sites[int(rng.integers(len(sites)))]
    ins = plan.per_stage[j][idx]
    s = tuple(ins.shape)
    inflated = (s[0], s[1] * 2 + 64) + s[2:]
    plan.per_stage[j][idx] = replace(ins, shape=inflated)
    return (f"inflated {ins.short()} shape {s} -> {inflated} "
            f"at stage {j} #{idx}")


def _mut_drop_opt(plan, rng):
    """Remove one REDUCE_AND_STEP: that stage never runs the optimizer."""
    sites = [(j, idx) for j, stream in enumerate(plan.per_stage)
             for idx, ins in enumerate(stream)
             if ins.op is Op.REDUCE_AND_STEP]
    if not sites:
        return None
    j, idx = sites[int(rng.integers(len(sites)))]
    del plan.per_stage[j][idx]
    return f"dropped REDUCE_AND_STEP at stage {j} #{idx}"


def _mut_duplicate_send(plan, rng):
    """Duplicate one send Start: the second pops an already-consumed
    buffer (use-after-send) and the peer has no second recv."""
    sites = _comm_sites(plan, SEND_OPS)
    if not sites:
        return None
    j, idx = sites[int(rng.integers(len(sites)))]
    ins = plan.per_stage[j][idx]
    plan.per_stage[j].insert(idx + 1, ins)
    return f"duplicated {ins.short()} at stage {j} #{idx}"


def _mut_corrupt_injection_meta(plan, rng):
    """Drop one entry from meta['injection_order']: mesh/pipelined
    backends would inject a micro-batch set that misses the plan's."""
    inj = plan.meta.get("injection_order")
    if not inj:
        return None
    k = int(rng.integers(len(inj)))
    dropped = inj[k]
    plan.meta["injection_order"] = [x for i, x in enumerate(inj) if i != k]
    return f"dropped mb {dropped} from meta injection_order"


PLAN_MUTATIONS: dict[str, Callable] = {
    "drop_wait": _mut_drop_wait,
    "swap_sends": _mut_swap_sends,
    "corrupt_peer": _mut_corrupt_peer,
    "inflate_shape": _mut_inflate_shape,
    "drop_opt": _mut_drop_opt,
    "duplicate_send": _mut_duplicate_send,
    "corrupt_injection_meta": _mut_corrupt_injection_meta,
}


def mutate_plan(plan, operator: str, seed: int = 0):
    """Apply one named mutation operator to a deep copy of ``plan``.

    Returns ``(mutant, description)`` or None if the operator has no
    applicable site. Deterministic in ``(plan, operator, seed)``.
    """
    if operator not in PLAN_MUTATIONS:
        raise ValueError(f"unknown plan mutation {operator!r}; "
                         f"have {sorted(PLAN_MUTATIONS)}")
    mutant = ExecutionPlan.from_json(plan.to_json())
    op_id = sorted(PLAN_MUTATIONS).index(operator)
    rng = np.random.default_rng([int(seed), 0xD3AD, op_id])
    desc = PLAN_MUTATIONS[operator](mutant, rng)
    if desc is None:
        return None
    return mutant, f"{operator}: {desc}"

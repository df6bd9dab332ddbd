"""Instruction executor (paper §3 "Executors").

Interprets :class:`ExecutionPlan` streams over ``n_stages`` pipeline stages,
each stage a thread driving real JAX compute:

- compute thread: FORWARD / BACKWARD / WAIT_* / REDUCE_AND_STEP in stream order
- comm thread per stage (the "communication stream"): executes SEND_*_START /
  RECV_*_START in stream order against **rendezvous, in-order channels** —
  one channel per device pair, sends block until the matching receive is
  posted and receives must consume in FIFO order (NCCL semantics, paper §2.3).
  A mismatched global order therefore deadlocks; ``DeadlockError`` is raised
  on timeout or tag mismatch instead of hanging, which is how the tests
  demonstrate the paper's Fig. 8 problem and validate the §6 plan.

Failure semantics (the robustness loop, ISSUE 7): every error a stage thread
raises — an XLA error from a callback, an injected fault, a real deadlock —
is surfaced as a structured :class:`PipelineError` carrying per-stage
diagnostics (which instruction each stage was executing, per micro-batch).
An internal **abort event** fans the failure out: peer stages blocked on
channels or waits observe it within ~50 ms and exit with
:class:`PipelineAborted` instead of timing out one by one, so ``run()``
reports the *primary* failure promptly rather than a cascade of secondary
channel timeouts. A genuinely stuck pipeline (no error, threads past the
deadline) reports which stage is stuck on which instruction.

``PipelineExecutor(..., hook=...)`` accepts a pre-instruction callback
``hook(stage, instr)`` on the compute stream — the fault-injection point
used by :mod:`repro_torch.dist.chaos` (delay = straggler, raise = stage crash).

Backward passes recompute the stage forward (activation checkpointing at
stage granularity) via ``jax.vjp`` — matching RecomputePolicy.FULL; the only
stashed state per in-flight micro-batch is its stage input, which is what the
planner's memory model charges.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.instructions import ExecutionPlan, Instr, Op

_POLL_S = 0.05                       # abort-observation latency bound


class PipelineError(RuntimeError):
    """Structured executor failure: which stage, which instruction, plus a
    per-stage diagnostic snapshot (``diagnostics``: one dict per stage with
    its state and current compute/comm instruction)."""

    def __init__(self, msg: str, stage: Optional[int] = None,
                 instr: Optional[Instr] = None,
                 diagnostics: Optional[list] = None):
        super().__init__(msg)
        self.stage = stage
        self.instr = instr
        self.diagnostics = diagnostics or []


class PlanRejectedError(PipelineError):
    """Strict mode refused a plan before execution: the static verifier
    (repro_torch.analysis) found ERROR-level defects. ``report`` carries the
    full :class:`~repro_torch.analysis.VerifyReport`."""

    def __init__(self, msg: str, report=None):
        super().__init__(msg)
        self.report = report


def reject_bad_plan(plan: ExecutionPlan, where: str) -> None:
    """Strict-mode gate shared by the executor and dist backends: verify
    ``plan`` statically and raise :class:`PlanRejectedError` on any
    ERROR-level finding (deadlock cycle, malformed IR, memory violation)."""
    from repro_torch.analysis import verify_plan   # deferred: analysis -> core
    report = verify_plan(plan)
    if report.errors:
        raise PlanRejectedError(
            f"{where}: refusing plan with {len(report.errors)} ERROR-level "
            f"finding(s)\n{report.summary()}", report=report)


class DeadlockError(PipelineError):
    """Communication-order mismatch or rendezvous timeout (paper Fig. 8)."""


class PipelineAborted(PipelineError):
    """Secondary failure: this stage was cleanly aborted because another
    stage errored first. Never the primary error reported by ``run()``."""


class Channel:
    """In-order rendezvous channel between one (src, dst) stage pair."""

    def __init__(self, name: str, timeout: float,
                 abort: Optional[threading.Event] = None):
        self.name = name
        self.timeout = timeout
        self.abort = abort if abort is not None else threading.Event()
        self._cv = threading.Condition()
        self._queue: deque = deque()        # (tag, payload, consumed_event)

    def poke(self) -> None:
        """Wake any thread blocked in recv so it can observe the abort."""
        with self._cv:
            self._cv.notify_all()

    def send(self, tag, payload):
        ev = threading.Event()
        with self._cv:
            self._queue.append((tag, payload, ev))
            self._cv.notify_all()
        deadline = time.monotonic() + self.timeout
        while not ev.wait(_POLL_S):
            if self.abort.is_set():
                raise PipelineAborted(
                    f"channel {self.name}: send {tag} aborted (peer failed)")
            if time.monotonic() > deadline:
                raise DeadlockError(
                    f"channel {self.name}: send {tag} never matched by a "
                    "receive (communication order mismatch)")
        return None

    def recv(self, tag):
        with self._cv:
            ok = self._cv.wait_for(
                lambda: len(self._queue) > 0 or self.abort.is_set(),
                self.timeout)
            if self.abort.is_set():
                raise PipelineAborted(
                    f"channel {self.name}: recv {tag} aborted (peer failed)")
            if not ok:
                raise DeadlockError(
                    f"channel {self.name}: recv {tag} timed out (no send posted)")
            head_tag, payload, ev = self._queue[0]
            if head_tag != tag:
                raise DeadlockError(
                    f"channel {self.name}: recv expected {tag} but channel "
                    f"head is {head_tag} (order mismatch -> NCCL deadlock)")
            self._queue.popleft()
        ev.set()
        return payload


@dataclass
class StageCallbacks:
    """The JAX side of one stage.

    forward(mb_id) -> None           stage 0 pulls its own micro-batch input
    forward(mb_id, h_in)             other stages consume the received tensor
      both return h_out (sent downstream) or None on the last stage
    backward(mb_id, g_out | None) -> g_in | None
      last stage passes g_out=None (it owns the loss)
    step() -> None                   REDUCE_AND_STEP
    """
    forward: Callable
    backward: Callable
    step: Callable


class StageExecutor:
    def __init__(self, stage: int, n_stages: int, plan_stream: list[Instr],
                 callbacks: StageCallbacks, channels: dict, timeout: float,
                 abort: threading.Event,
                 hook: Optional[Callable[[int, Instr], None]] = None):
        self.stage = stage
        self.n_stages = n_stages
        self.stream = plan_stream
        self.cb = callbacks
        self.channels = channels
        self.timeout = timeout
        self.abort = abort
        self.hook = hook
        self.comm_q: "queue.Queue[Optional[Instr]]" = queue.Queue()
        self.recv_done: dict[tuple, threading.Event] = {}
        self.recv_buf: dict[tuple, Any] = {}
        self.send_buf: dict[tuple, Any] = {}
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        # diagnostic state: what each thread is currently executing
        self.compute_pos: Optional[tuple[int, Instr]] = None   # (idx, instr)
        self.comm_pos: Optional[Instr] = None
        self.compute_done = False
        self.comm_done = False

    # ------------------------------ comm thread ------------------------
    @staticmethod
    def _dir(src: int, dst: int) -> str:
        return f"{src}->{dst}"

    def comm_loop(self):
        try:
            while True:
                ins = self.comm_q.get()
                if ins is None:
                    self.comm_done = True
                    return
                self.comm_pos = ins
                if ins.op == Op.SEND_ACT_START:
                    tag = ("act", ins.micro_batch)
                    payload = self._pop_send(("act", ins.micro_batch))
                    self.channels[self._dir(self.stage, ins.peer)].send(tag, payload)
                elif ins.op == Op.SEND_GRAD_START:
                    tag = ("grad", ins.micro_batch)
                    payload = self._pop_send(("grad", ins.micro_batch))
                    self.channels[self._dir(self.stage, ins.peer)].send(tag, payload)
                elif ins.op == Op.RECV_ACT_START:
                    tag = ("act", ins.micro_batch)
                    data = self.channels[self._dir(ins.peer, self.stage)].recv(tag)
                    self._post_recv(tag, data)
                elif ins.op == Op.RECV_GRAD_START:
                    tag = ("grad", ins.micro_batch)
                    data = self.channels[self._dir(ins.peer, self.stage)].recv(tag)
                    self._post_recv(tag, data)
        except BaseException as e:  # propagate to run()
            self.error = self.error or e

    def _pop_send(self, key):
        # payload must have been produced by the compute thread already
        # (Start ops are planned at production time), so this never blocks
        # long; guard anyway.
        t0 = time.monotonic()
        while True:
            with self._lock:
                if key in self.send_buf:
                    return self.send_buf.pop(key)
            if self.abort.is_set():
                raise PipelineAborted(
                    f"stage {self.stage}: send {key} aborted (peer failed)")
            if time.monotonic() - t0 > self.timeout:
                raise DeadlockError(f"stage {self.stage}: send payload {key} "
                                    "never produced")
            time.sleep(0.0005)

    def _post_recv(self, tag, data):
        with self._lock:
            self.recv_buf[tag] = data
            ev = self.recv_done.setdefault(tag, threading.Event())
        ev.set()

    def _wait_recv(self, tag):
        with self._lock:
            ev = self.recv_done.setdefault(tag, threading.Event())
        deadline = time.monotonic() + self.timeout
        while not ev.wait(_POLL_S):
            if self.abort.is_set():
                raise PipelineAborted(
                    f"stage {self.stage}: wait on {tag} aborted (peer failed)")
            if time.monotonic() > deadline:
                raise DeadlockError(
                    f"stage {self.stage}: wait on {tag} timed out")
        with self._lock:
            return self.recv_buf.pop(tag)

    # ----------------------------- compute thread ----------------------
    def compute_loop(self):
        try:
            for idx, ins in enumerate(self.stream):
                self.compute_pos = (idx, ins)
                if self.hook is not None:
                    self.hook(self.stage, ins)
                if ins.op in (Op.SEND_ACT_START, Op.SEND_GRAD_START,
                              Op.RECV_ACT_START, Op.RECV_GRAD_START):
                    self.comm_q.put(ins)
                elif ins.op == Op.WAIT_RECV_ACT:
                    h = self._wait_recv(("act", ins.micro_batch))
                    with self._lock:
                        self.recv_buf[("act_ready", ins.micro_batch)] = h
                elif ins.op == Op.WAIT_RECV_GRAD:
                    g = self._wait_recv(("grad", ins.micro_batch))
                    with self._lock:
                        self.recv_buf[("grad_ready", ins.micro_batch)] = g
                elif ins.op == Op.FORWARD:
                    if self.stage == 0:
                        h_out = self.cb.forward(ins.micro_batch)
                    else:
                        with self._lock:
                            h_in = self.recv_buf.pop(("act_ready", ins.micro_batch))
                        h_out = self.cb.forward(ins.micro_batch, h_in)
                    if self.stage + 1 < self.n_stages:
                        with self._lock:
                            self.send_buf[("act", ins.micro_batch)] = h_out
                elif ins.op == Op.BACKWARD:
                    if self.stage + 1 < self.n_stages:
                        with self._lock:
                            g_out = self.recv_buf.pop(("grad_ready", ins.micro_batch))
                    else:
                        g_out = None
                    g_in = self.cb.backward(ins.micro_batch, g_out)
                    if self.stage > 0:
                        with self._lock:
                            self.send_buf[("grad", ins.micro_batch)] = g_in
                elif ins.op == Op.REDUCE_AND_STEP:
                    self.cb.step()
            self.compute_done = True
            self.comm_q.put(None)
        except BaseException as e:
            self.error = self.error or e
            self.comm_q.put(None)

    # ------------------------------ diagnostics ------------------------
    def snapshot(self) -> dict:
        """One diagnostic row for PipelineError.diagnostics."""
        idx, ins = self.compute_pos if self.compute_pos else (None, None)
        state = "error" if self.error is not None else (
            "done" if self.compute_done else "running")
        return {
            "stage": self.stage,
            "state": state,
            "compute_instr": ins.short() if ins is not None else None,
            "compute_index": idx,
            "compute_total": len(self.stream),
            "comm_instr": (self.comm_pos.short()
                           if self.comm_pos is not None else None),
            "micro_batch": ins.micro_batch if ins is not None else None,
            "error": repr(self.error) if self.error is not None else None,
        }

    def describe_position(self) -> str:
        if self.compute_pos is None:
            return "before first instruction"
        idx, ins = self.compute_pos
        return f"instruction {idx}/{len(self.stream)} ({ins.short()})"


class PipelineExecutor:
    """Runs one iteration's ExecutionPlan across all stages (threads).

    ``hook(stage, instr)`` — optional pre-instruction callback on every
    compute stream (fault injection / tracing). Raising from the hook is
    equivalent to the stage crashing on that instruction.

    ``strict=True`` statically verifies the plan (repro_torch.analysis) before
    spawning any thread and raises :class:`PlanRejectedError` on
    ERROR-level findings — a defective plan then fails in microseconds
    with a counterexample instead of via a channel timeout.
    """

    def __init__(self, plan: ExecutionPlan, callbacks: list[StageCallbacks],
                 timeout: float = 30.0,
                 hook: Optional[Callable[[int, Instr], None]] = None,
                 strict: bool = False):
        self.plan = plan
        self.callbacks = callbacks
        self.timeout = timeout
        self.hook = hook
        self.strict = strict

    def run(self):
        if self.strict:
            reject_bad_plan(self.plan, "PipelineExecutor")
        c = self.plan.n_stages
        abort = threading.Event()
        channels = {}
        for j in range(c - 1):
            channels[f"{j}->{j+1}"] = Channel(f"{j}->{j+1}", self.timeout, abort)
            channels[f"{j+1}->{j}"] = Channel(f"{j+1}->{j}", self.timeout, abort)
        stages = [
            StageExecutor(j, c, self.plan.per_stage[j], self.callbacks[j],
                          channels, self.timeout, abort, hook=self.hook)
            for j in range(c)
        ]
        threads = []
        for s in stages:
            tc = threading.Thread(target=s.compute_loop, daemon=True)
            tm = threading.Thread(target=s.comm_loop, daemon=True)
            threads += [tc, tm]
            tc.start()
            tm.start()

        def _broadcast_abort():
            abort.set()
            for ch in channels.values():
                ch.poke()
            for s in stages:
                s.comm_q.put(None)   # unblock comm threads idle on get()

        deadline = time.monotonic() + self.timeout * (
            len(self.plan.micro_batches) + 4)
        pending = list(threads)
        while pending:
            if not abort.is_set() and any(s.error for s in stages):
                # a stage died: fan out the abort so peers fail fast with
                # PipelineAborted instead of cascading channel timeouts
                _broadcast_abort()
            pending[0].join(_POLL_S)
            if not pending[0].is_alive():
                pending.pop(0)
                continue
            if time.monotonic() > deadline:
                break

        if pending and not abort.is_set():
            # genuinely stuck (no stage error, deadline blown): abort so the
            # daemon threads unwind, then report who was stuck where
            _broadcast_abort()
            t_grace = time.monotonic() + 5 * _POLL_S
            for t in pending:
                t.join(max(0.0, t_grace - time.monotonic()))

        errors = [(s.stage, s.error) for s in stages if s.error is not None]
        primary = next(((j, e) for j, e in errors
                        if not isinstance(e, PipelineAborted)), None)
        diag = [s.snapshot() for s in stages]

        if primary is not None:
            j, e = primary
            if isinstance(e, PipelineError):
                # deadlocks & aborts are already structured — keep their
                # concrete class (tests match DeadlockError) and attach the
                # full per-stage snapshot
                e.stage = e.stage if e.stage is not None else j
                e.diagnostics = diag
                raise e
            instr = stages[j].compute_pos[1] if stages[j].compute_pos else None
            raise PipelineError(
                f"stage {j} failed at {stages[j].describe_position()}: {e!r}",
                stage=j, instr=instr, diagnostics=diag) from e

        if any(t.is_alive() for t in threads):
            stuck = [s for s in stages
                     if not (s.compute_done and s.comm_done)]
            where = "; ".join(
                f"stage {s.stage} stuck at {s.describe_position()}"
                for s in stuck) or "unknown stage"
            raise PipelineError(
                f"executor threads did not terminate: {where}",
                stage=stuck[0].stage if stuck else None,
                diagnostics=diag)

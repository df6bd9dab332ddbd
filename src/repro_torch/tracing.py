"""Spans and counters on the port's training path.

- :func:`span` marks a layer's interval. With tracing off (the default)
  it costs a flag check and records nothing. With tracing on it keeps a
  record in memory (name, parent span, iteration, thread, host start and
  end from ``perf_counter_ns``) and, on a thread a torch profiler records,
  opens ``record_function("repro_torch." + name)``, so the span sits on the
  profiler's timeline beside the device's work. ``device=`` a CUDA device
  also records two timing events on its current stream, resolved only when
  :func:`totals` or :func:`records` reads them (one synchronise, never on
  the hot path); on any other device the work is done when the call
  returns, so the device extent is the host's.
- :func:`timed` is a span whose host duration the caller reads
  (``.seconds``) whether tracing is on or not: the counters the program
  keeps for the same interval read it, so each interval has one clock.
- :func:`count` adds to a counter of the innermost span open on the
  calling thread.
- :func:`iteration` sets the iteration id the spans of one iteration
  share, on every thread.

Tracing is on after :func:`enable`, and while a torch profiler records on
some thread: the profiler is on for the thread that started it (and
autograd's), and the other threads (a pipeline's stages) record in memory
meanwhile. A recording is one stretch in which tracing stays on: the
first span or count after tracing was seen off starts a new one, and
:func:`totals` and :func:`records` read the newest. So a profiled window's
records are that window's.

The spans and counters on the training path, and what each is for:

=================  =====================================================
``iteration``      ``PlanAheadRunner.run``'s loop body (``exec_s``, the
                   history's ``time_s``)
``plan_wait``      ``PlanAheadRunner._obtain`` (``plan_wait_s``)
``materialise``    ``PlanAheadRunner._execute_replica``'s micro-batches
                   (input time)
``h2d``            the sequential path's host-to-device copies; counter
                   ``sync``, one per blocking copy (input time, syncs)
``forward``        ``_value_and_grad``'s loss (device extent)
``backward``       ``_value_and_grad``'s ``torch.autograd.grad``
``optimizer``      ``adamw_update``, the global norm included (device)
``sync``           the host waiting on the device: the loss and norm
                   reads; counter ``sync``
=================  =====================================================

RoPE's theta, copied in from pageable memory on every call, adds to the
``sync`` counter of the span open around it (``forward``, ``backward``)
without a span of its own. On a CUDA device the ``sync`` counter an
iteration equals the blocking calls ``torch.cuda.set_sync_debug_mode``
reports (``tests/test_torch_tracing.py``, marked ``cuda``).
"""
from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

PREFIX = "repro_torch."

_profiler_enabled = None


def _profiling() -> bool:
    """Whether a torch profiler records on this thread; without torch
    loaded none can."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


@dataclass(eq=False)
class Record:
    """One closed span. ``parent`` is the ``id`` of the span that was open
    around it on the same thread, or None."""
    id: int
    name: str
    parent: Optional[int]
    iteration: Optional[int]
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    child_ns: int = 0             # host time its children covered
    device_s: float = 0.0         # its device extent, once resolved
    counters: dict = field(default_factory=dict)
    events: object = None         # (start, end, device) until resolved

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_s(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) * 1e-9


@dataclass
class Total:
    """One span name's sums over the newest recording."""
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    counters: dict = field(default_factory=dict)


# what a span does: nothing, records, records and annotates the profiler's
# timeline
_OFF, _ON, _ANNOTATED = 0, 1, 2


class _Recorder:
    """The process's recordings; every function of this module acts on
    the one instance, ``_R``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.enabled = False
        self.live = False             # a recording is going on
        self.owner = None             # the profiled thread that began it
        self.generation = 0
        self.iteration: Optional[int] = None
        self.records: list[Record] = []
        self.loose: dict = {}         # counts made outside any span
        self.local = threading.local()
        self.ids = itertools.count()

    def mode(self) -> int:
        prof = _profiling()
        if self.enabled or prof:
            if not self.live:
                with self.lock:
                    if not self.live:
                        self.records, self.loose = [], {}
                        self.generation += 1
                        self.owner = (None if self.enabled
                                      else threading.get_ident())
                        self.live = True
            return _ANNOTATED if prof else _ON
        if self.live:
            if self.owner is not None \
                    and self.owner != threading.get_ident():
                return _ON            # profiled on another thread
            self.live = False
        return _OFF

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_R = _Recorder()


_NOTHING = contextlib.nullcontext()     # a span with tracing off


class _Span:
    __slots__ = ("name", "device", "mode", "rec", "gen", "rf", "t0",
                 "seconds")

    def __init__(self, name, device, mode=None):
        self.name, self.device, self.mode = name, device, mode
        self.rec = self.rf = None
        self.seconds = 0.0

    def __enter__(self):
        mode = self.mode if self.mode is not None else _R.mode()
        if mode:
            import torch
            stack = _R.stack()
            self.gen = _R.generation
            rec = self.rec = Record(
                next(_R.ids), self.name, stack[-1].id if stack else None,
                _R.iteration, threading.get_ident())
            stack.append(rec)
            if mode == _ANNOTATED:
                self.rf = torch.profiler.record_function(PREFIX + self.name)
                self.rf.__enter__()
            dev = self.device
            if dev is not None and dev.type == "cuda":
                rec.events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True), dev)
                rec.events[0].record(torch.cuda.current_stream(dev))
        self.t0 = time.perf_counter_ns()
        if self.rec is not None:
            self.rec.start_ns = self.t0
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self.t0) * 1e-9
        rec = self.rec
        if rec is None:
            return False
        if rec.events is not None:
            import torch
            rec.events[1].record(torch.cuda.current_stream(self.device))
        elif self.device is not None:
            rec.device_s = self.seconds
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec.end_ns = t1
        stack = _R.stack()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:            # closed out of order
            stack.remove(rec)
        if stack:
            stack[-1].child_ns += t1 - rec.start_ns
        with _R.lock:
            if self.gen == _R.generation:
                _R.records.append(rec)
        return False


def span(name: str, *, device=None):
    """A context manager marking ``name``'s interval; ``device`` (a
    ``torch.device``) is where the interval's work runs."""
    mode = _R.mode()
    if not mode:
        return _NOTHING
    return _Span(name, device, mode)


def timed(name: str) -> _Span:
    """:func:`span` that also times the host when tracing is off: read
    ``.seconds`` after the ``with`` block."""
    return _Span(name, None)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` of the innermost span open on this
    thread (outside any span, to the recording's own)."""
    if not _R.mode():
        return
    stack = _R.stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n
    else:
        with _R.lock:
            _R.loose[name] = _R.loose.get(name, 0) + n


def iteration(it: Optional[int]) -> None:
    """The iteration the spans that open from now on belong to."""
    _R.iteration = it


def enable() -> None:
    """Tracing on without a profiler (tests, operators, the cost of
    tracing itself)."""
    _R.enabled = True


def disable() -> None:
    _R.enabled = False
    if _R.owner is None:
        _R.live = False


def records() -> list[Record]:
    """The newest recording's closed spans, in the order they closed."""
    with _R.lock:
        recs = list(_R.records)
    pending = [r for r in recs if r.events is not None]
    if pending:
        import torch
        for d in {r.events[2] for r in pending}:
            torch.cuda.synchronize(d)
        for r in pending:
            r.device_s = r.events[0].elapsed_time(r.events[1]) * 1e-3
            r.events = None
    return recs


def totals() -> dict[str, Total]:
    """Per span name, its sums over the newest recording; counts made
    outside any span are under ``""``."""
    out: dict[str, Total] = {}
    for r in records():
        t = out.setdefault(r.name, Total())
        t.count += 1
        t.host_s += r.host_s
        t.self_s += r.self_s
        t.device_s += r.device_s
        for k, v in r.counters.items():
            t.counters[k] = t.counters.get(k, 0) + v
    with _R.lock:
        if _R.loose:
            out.setdefault("", Total()).counters.update(_R.loose)
    return out

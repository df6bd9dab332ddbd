"""The port's spans and counters (``repro_torch.tracing``): parents, self
time and counters; nothing recorded and no profiler annotation with tracing
off; every span on a profiler's timeline; a recording replacing the one
before; and a tiny plan-ahead run whose losses, gradients and weights are
the same to the bit with tracing on and off, its counters read from the
spans' clocks. On a card (marked ``cuda``, skipped without one), the ``sync``
counter of an iteration equals the blocking calls
``torch.cuda.set_sync_debug_mode`` reports over it:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_tracing.py
"""
import collections
import threading
import time
import traceback
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.models import model as TM
from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
from repro_torch.tree import flatten

torch.set_num_threads(1)

ITERS = 3
CFG = reduced(get_arch("gpt-paper"))
N_LAYERS = CFG.n_layers


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def test_parents_self_time_and_counters_from_two_threads():
    tracing.enable()
    tracing.iteration(7)
    with tracing.span("outer"):
        time.sleep(0.02)
        with tracing.span("inner", device=torch.device("cpu")):
            tracing.count("sync", 2)
            time.sleep(0.01)
        tracing.count("sync")

        def planner():
            with tracing.span("plan"):
                tracing.count("sync", 5)
                time.sleep(0.005)
        t = threading.Thread(target=planner)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    tracing.count("loose", 3)
    recs = {r.name: r for r in tracing.records()}
    assert set(recs) == {"outer", "inner", "plan"}
    outer, inner, plan = recs["outer"], recs["inner"], recs["plan"]
    assert outer.parent is None and inner.parent == outer.id
    assert plan.parent is None and plan.thread != outer.thread
    assert (outer.iteration, inner.iteration, plan.iteration) == (7, 7, 7)
    # the other thread's span is no child of the span open on this one
    assert outer.self_s == pytest.approx(outer.host_s - inner.host_s)
    assert outer.self_s >= 0.02 and inner.host_s >= 0.01
    assert inner.device_s == inner.host_s and outer.device_s == 0.0
    tot = tracing.totals()
    assert tot["outer"].counters == {"sync": 1}
    assert tot["inner"].counters == {"sync": 2}
    assert tot["plan"].counters == {"sync": 5}
    assert tot[""].counters == {"loose": 3}
    assert tot["outer"].count == 1
    assert tot["outer"].host_s == pytest.approx(outer.host_s)


def test_tracing_off_records_nothing_and_opens_no_record_function(
        monkeypatch):
    tracing.enable()
    with tracing.span("kept"):
        pass
    before = tracing.records()
    tracing.disable()

    def refuse(*a, **k):
        raise AssertionError("record_function opened with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("a", device=torch.device("cpu")):
        tracing.count("sync")
    with tracing.timed("b") as b:
        time.sleep(0.001)
    assert b.seconds >= 0.001                  # timed spans time the host
    assert [r.name for r in tracing.records()] \
        == [r.name for r in before] == ["kept"]
    # enable() without a profiler records, but annotates nothing
    tracing.enable()
    with tracing.span("c"):
        pass
    assert [r.name for r in tracing.records()] == ["c"]


def test_a_second_recording_replaces_the_first():
    tracing.enable()
    with tracing.span("first"):
        tracing.count("sync")
    tracing.disable()
    with tracing.span("unseen"):
        pass
    assert [r.name for r in tracing.records()] == ["first"]
    tracing.enable()
    with tracing.span("second"):
        pass
    assert [r.name for r in tracing.records()] == ["second"]
    assert set(tracing.totals()) == {"second"}


def _runner():
    stream = MultiTaskStream(StreamConfig(
        n_tasks=8, global_tokens=512, max_len=64, vocab=512,
        tail_fraction=0.1, tail_alpha=1.2, seed=0))
    pcfg = PlannerConfig(n_stages=1, d_model=CFG.d_model,
                         palette=ShapePalette.build(min_seq=32, max_seq=64,
                                                    seq_align=32, max_mbs=4))
    rcfg = RunnerConfig(n_iters=ITERS, use_executor=False, log_every=0,
                        device="cpu")
    grads = []

    class Runner(PlanAheadRunner):
        def _execute_replica(self, *a, **k):
            g, ls, ws = super()._execute_replica(*a, **k)
            grads.append([x.clone() for _, x in flatten(g)])
            return g, ls, ws
    params = TM.init_params(torch.Generator().manual_seed(3), CFG,
                            device="cpu")
    return Runner(CFG, AnalyticCostModel(CFG, n_stages=1), pcfg, rcfg,
                  stream, params=params), grads


@pytest.fixture(scope="module")
def runs():
    """The tiny run three times: tracing off, under ``enable()``, under a
    CPU profiler; each ``(params, history, stats, grads, totals, events)``."""
    out = {}
    for how in ("off", "enabled", "profiled"):
        tracing.disable()
        runner, grads = _runner()
        events = None
        if how == "enabled":
            tracing.enable()
            params, hist, stats = runner.run()
            tracing.disable()
        elif how == "profiled":
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                params, hist, stats = runner.run()
            events = [e.name for e in prof.events()]
        else:
            params, hist, stats = runner.run()
        out[how] = (params, hist, stats, grads,
                    tracing.totals() if how != "off" else None,
                    tracing.records() if how != "off" else None, events)
    return out


def test_tracing_leaves_losses_gradients_and_weights_bit_identical(runs):
    p0, h0, _, g0 = runs["off"][:4]
    assert len(h0) == ITERS and any(h["n_micro"] > 1 for h in h0)
    for how in ("enabled", "profiled"):
        p1, h1, _, g1 = runs[how][:4]
        assert [(h["loss"], h["grad_norm"]) for h in h1] \
            == [(h["loss"], h["grad_norm"]) for h in h0], how
        assert len(g1) == len(g0)
        for a, b in zip(g0, g1):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), how
        for (name, a), (_, b) in zip(flatten(p0), flatten(p1)):
            assert torch.equal(a, b), (how, name)


def test_every_profiled_span_is_on_the_profilers_timeline(runs):
    totals, events = runs["profiled"][4], runs["profiled"][6]
    for name, t in totals.items():
        assert events.count(tracing.PREFIX + name) == t.count, name
    assert {"forward", "backward", "optimizer", "materialise", "h2d",
            "sync", "iteration", "plan_wait"} <= set(totals)


@pytest.mark.parametrize("how", ["enabled", "profiled"])
def test_spans_count_the_step_and_feed_the_runners_counters(runs, how):
    _, hist, stats, _, totals, recs, _ = runs[how]
    n_micro = sum(h["n_micro"] for h in hist)
    for name in ("forward", "backward", "h2d"):
        assert totals[name].count == n_micro, name
    for name in ("optimizer", "materialise", "plan_wait"):
        assert totals[name].count == ITERS, name
    by_id = {r.id: r for r in recs}
    # RoPE's theta made a device tensor: q and k of each layer, in the
    # forward and again in the backward's recompute, counted in the span
    # around it
    rope = 2 * N_LAYERS * n_micro
    assert totals["forward"].counters == totals["backward"].counters \
        == {"sync": rope}
    assert "sync" not in {by_id[r.parent].name for r in recs
                          if r.name == "sync"}
    # besides, five inputs copied and two loss reads a micro-batch, one
    # norm read
    syncs = sum(t.counters.get("sync", 0) for t in totals.values())
    assert syncs == 7 * n_micro + ITERS + 2 * rope
    its = [r for r in recs if r.name == "iteration"]
    assert [r.iteration for r in its] == list(range(ITERS))
    assert [h["time_s"] for h in hist] == [r.host_s for r in its]
    assert stats.exec_s == pytest.approx(sum(r.host_s for r in its))
    waits = [r for r in recs if r.name == "plan_wait"]
    assert [h["plan_wait_s"] for h in hist] == [r.host_s for r in waits]
    assert stats.plan_wait_s == pytest.approx(sum(r.host_s for r in waits))
    for r in recs:
        if r.name in ("forward", "backward", "h2d", "materialise",
                      "optimizer", "plan_wait"):
            assert by_id[r.parent].name == "iteration", r.name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gpt-paper", "t5-paper"])
def test_sync_counter_equals_the_sync_debug_modes_count(arch):
    """One iteration of a tiny plan-ahead run on the card, after one of
    warm-up: every call that blocks the host on the device is one the
    program counts, and the program counts nothing that does not block.
    The window runs from the iteration's ``_obtain`` to the next's, as the
    benchmark's cycle boundaries do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    from repro_torch.kernels import _build
    cfg = reduced(get_arch(arch))
    _build.preload(cfg)
    t5 = arch == "t5-paper"
    stream = MultiTaskStream(StreamConfig(
        n_tasks=8, global_tokens=512, max_len=96 if t5 else 64, vocab=512,
        tail_fraction=0.1, tail_alpha=1.2, encdec_fraction=float(t5),
        seed=0))
    pcfg = PlannerConfig(n_stages=1, d_model=cfg.d_model,
                         palette=ShapePalette.build(min_seq=32, max_seq=128,
                                                    seq_align=32, max_mbs=4))
    rcfg = RunnerConfig(n_iters=3, use_executor=False, log_every=0,
                        device="cuda")
    seen, window = [], []

    def seen_sync(message, category, filename, lineno, *rest):
        if "synchroniz" in str(message):
            seen.append(" < ".join(
                f"{Path(f.filename).name}:{f.lineno}"
                for f in traceback.extract_stack()[-2:-8:-1]))

    class Runner(PlanAheadRunner):
        def _obtain(self, it, stats=None):
            if it == 1:
                # the switch itself warns, once a process: before the window
                torch.cuda.set_sync_debug_mode("warn")
                window.append(warnings.catch_warnings())
                window[0].__enter__()
                warnings.simplefilter("always")
                warnings.showwarning = seen_sync
                tracing.enable()
            elif it == 2:
                torch.cuda.set_sync_debug_mode(0)
                tracing.disable()
                window[0].__exit__(None, None, None)
            return super()._obtain(it, stats)
    try:
        _, hist, _ = Runner(cfg, AnalyticCostModel(cfg, n_stages=1), pcfg,
                            rcfg, stream).run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(hist) == 3 and hist[1]["n_micro"] >= 1
    counted = sum(t.counters.get("sync", 0)
                  for t in tracing.totals().values())
    assert counted == len(seen), collections.Counter(seen)
    assert counted >= hist[1]["n_micro"]

"""The port's fault-tolerant training loop against the reference's.

The reference's chaos and runner tests (``tests/test_fault_tolerance.py``)
on the port at its size (reduced gpt-paper with 2 layers, the same stream
and palette), on the CPU: faults fire once, planner faults resubmit, stage
crashes retry (sequential and on the 2-stage pipeline), a state-losing
crash restores the newest checkpoint and replays, retries that run out
leave an emergency checkpoint, a dead replica shrinks ``dp_size``. The
invariant throughout: a faulted run's last-occurrence trajectory equals
the fault-free one's to the bit. Then parity with the reference: one fault
schedule through both runners gives the same recoveries and the same
iteration sequence, and the port resumes from a checkpoint the reference
wrote and continues as the reference does (f32, 2e-4, the f32 GRAD_TOL of
tests/test_torch_pipeline.py). Last the port's own hazard: a failure that
escapes from inside the in-place AdamW update writes no checkpoint.
"""
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.cost_model import AnalyticCostModel as JCost
from repro.core.planner import PlannerConfig as JPlannerConfig
from repro.core.shapes import ShapePalette as JPalette
from repro.data.streams import MultiTaskStream as JStream
from repro.data.streams import StreamConfig as JStreamConfig
from repro.dist import chaos as JC
from repro.dist.fault import StragglerMonitor as JMonitor
from repro.train.runner import PlanAheadRunner as JRunner
from repro.train.runner import RunnerConfig as JRunnerConfig
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.executor import PipelineError
from repro_torch.core.instructions import Instr, Op
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.dist.chaos import (FaultEvent, FaultKind, FaultSchedule,
                                    InjectedFault, LogicalClock)
from repro_torch.dist.fault import StragglerMonitor
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as TO
from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
from repro_torch.tree import flatten

# tiny tensors: two intra-op threads, so that pytest-xdist's workers do
# not oversubscribe the CPU
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(reduced(get_arch("gpt-paper")), n_layers=2)
JCFG = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")), n_layers=2)
PAL = dict(min_seq=32, max_seq=128, seq_align=32, max_mbs=8)
STREAM = dict(n_tasks=8, global_tokens=512, max_len=128, vocab=CFG.vocab,
              seed=5)
F32_TOL = 2e-4


def _runner(n_iters=5, n_stages=1, dp_size=1, use_executor=False,
            synchronous=False, chaos=None, monitor=None, ckpt_dir="",
            ckpt_every=0, max_retries=2, plan_timeout=20.0,
            drift_tolerance=1.2, cfg=CFG, **kw):
    pcfg = PlannerConfig(n_stages=n_stages, dp_size=dp_size,
                         d_model=cfg.d_model, palette=ShapePalette.build(**PAL))
    rcfg = RunnerConfig(n_iters=n_iters, synchronous=synchronous,
                        use_executor=use_executor, log_every=0,
                        ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                        max_retries=max_retries, plan_timeout=plan_timeout,
                        retry_backoff_s=0.01, drift_tolerance=drift_tolerance,
                        exec_timeout=30.0, device="cpu", **kw)
    return PlanAheadRunner(cfg, AnalyticCostModel(cfg, n_stages=n_stages),
                           pcfg, rcfg, MultiTaskStream(StreamConfig(**STREAM)),
                           monitor=monitor, chaos=chaos)


def _jrunner(n_iters, dp_size=1, chaos=None, monitor=None, ckpt_dir="",
             ckpt_every=0, plan_timeout=20.0, cfg=JCFG, **kw):
    pcfg = JPlannerConfig(n_stages=1, dp_size=dp_size, d_model=cfg.d_model,
                          palette=JPalette.build(**PAL))
    rcfg = JRunnerConfig(n_iters=n_iters, use_executor=False, log_every=0,
                         ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                         plan_timeout=plan_timeout, retry_backoff_s=0.01,
                         exec_timeout=30.0, impl="ref", **kw)
    return JRunner(cfg, JCost(cfg, n_stages=1), pcfg, rcfg,
                   JStream(JStreamConfig(**STREAM)), monitor=monitor,
                   chaos=chaos)


def _last(history) -> dict:
    """iter -> (loss, grad norm) of its last occurrence (a replay logs an
    iteration again)."""
    return {h["iter"]: (h["loss"], h["grad_norm"]) for h in history}


def _same_params(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(flatten(a),
                                                          flatten(b)))


# ------------------------------------------------------------------ chaos --
def test_seeded_schedule_is_deterministic_and_the_references():
    a, b = FaultSchedule.seeded(7, 20), FaultSchedule.seeded(7, 20)
    assert a.describe() == b.describe() == JC.FaultSchedule.seeded(
        7, 20).describe()
    assert {e.kind for e in a.events} == {
        FaultKind.STRAGGLER, FaultKind.PLANNER_LOST,
        FaultKind.STAGE_CRASH, FaultKind.REPLICA_DEAD}
    assert FaultSchedule.seeded(8, 20).describe() != a.describe()


def test_fault_events_fire_at_most_once():
    sched = FaultSchedule([FaultEvent(2, FaultKind.STAGE_CRASH, stage=0)])
    hook = sched.executor_hook(2, replica=0)
    with pytest.raises(InjectedFault) as ei:
        hook(0, Instr(Op.FORWARD, 0))
    assert ei.value.event.iteration == 2
    hook(0, Instr(Op.FORWARD, 1))          # already fired: no raise
    assert sched.executor_hook(3) is None  # other iterations unaffected
    assert len(sched.log) == 1 and not sched.pending()


# ---------------------------------------------------- runner: planner --
def test_planner_faults_resubmit_bitwise():
    chaos = FaultSchedule([FaultEvent(1, FaultKind.PLANNER_CRASH),
                           FaultEvent(2, FaultKind.PLANNER_LOST)])
    p_fault, h_fault, s_fault = _runner(n_iters=4, chaos=chaos,
                                        plan_timeout=0.5).run()
    p_free, h_free, _ = _runner(n_iters=4).run()
    assert _last(h_fault) == _last(h_free)
    assert [h["iter"] for h in h_fault] == [0, 1, 2, 3]
    assert _same_params(p_fault, p_free)
    assert "planner_resubmit" in {r["kind"] for r in s_fault.recoveries}
    assert s_fault.faults >= 2 and not chaos.pending()


# ----------------------------------------------- runner: stage crashes --
@pytest.mark.parametrize("path", ["sequential", "pipelined"])
def test_stage_crash_retries_bitwise(path):
    """A crash on stage 0 (sequential) or stage 1's backward on the
    2-stage pipeline, its peer stage mid-plan: the iteration is retried
    with the state in memory, and the retry's stage gradients start from
    none."""
    kw = (dict(n_stages=2, use_executor=True) if path == "pipelined"
          else {})
    ev = (FaultEvent(1, FaultKind.STAGE_CRASH, stage=1, op="B")
          if path == "pipelined" else
          FaultEvent(2, FaultKind.STAGE_CRASH, stage=0))
    chaos = FaultSchedule([ev])
    p_fault, h_fault, s_fault = _runner(n_iters=4, chaos=chaos, **kw).run()
    p_free, h_free, _ = _runner(n_iters=4, **kw).run()
    assert _last(h_fault) == _last(h_free)
    assert _same_params(p_fault, p_free)
    assert s_fault.faults == 1 and s_fault.recovery_s > 0
    assert [r["kind"] for r in s_fault.recoveries] == ["retry"]


def test_state_lost_restores_from_checkpoint(tmp_path):
    chaos = FaultSchedule([
        FaultEvent(3, FaultKind.STAGE_CRASH, stage=0, state_lost=True)])
    p_fault, h_fault, s_fault = _runner(
        n_iters=6, chaos=chaos, ckpt_dir=tmp_path / "a", ckpt_every=2).run()
    p_free, h_free, _ = _runner(
        n_iters=6, ckpt_dir=tmp_path / "b", ckpt_every=2).run()
    restores = [r for r in s_fault.recoveries
                if r["kind"] == "checkpoint_restore"]
    assert restores and restores[0]["restored_step"] == 2
    # iteration 3 failed, 2..3 replayed: history logs 2 twice
    iters = [h["iter"] for h in h_fault]
    assert iters.count(2) == 2 and iters == [0, 1, 2, 2, 3, 4, 5]
    assert _last(h_fault) == _last(h_free)
    assert _same_params(p_fault, p_free)
    loads = [c for c in s_fault.checkpoints if c["kind"] == "load"]
    assert [c["step"] for c in loads] == [2] and loads[0]["bytes"] > 0
    assert [c["step"] for c in s_fault.checkpoints
            if c["kind"] == "save"] == [2, 4, 6]


def test_emergency_checkpoint_on_exhausted_retries(tmp_path):
    chaos = FaultSchedule([FaultEvent(1, FaultKind.STAGE_CRASH, stage=0)])
    with pytest.raises((PipelineError, InjectedFault)):
        _runner(n_iters=4, chaos=chaos, max_retries=0,
                ckpt_dir=tmp_path).run()
    step = CKPT.latest_step(tmp_path)
    assert step == 1
    manifest = json.loads(
        (tmp_path / f"step_{step:08d}" / "manifest.json").read_text())
    assert manifest["extra"]["emergency"] is True


def test_emergency_checkpoint_after_the_update_is_labelled_by_its_step(
        tmp_path, monkeypatch):
    """The periodic save after iteration 1's update fails. The state then
    holds two updates, so the emergency checkpoint is step 2 (the
    optimizer's count, not the loop's iteration 1), and a restart resumes
    at iteration 2 and goes on as the fault-free run does, to the bit."""
    real, steps = CKPT.save, []

    def fails_once(*a, **k):
        steps.append(a[1])
        if len(steps) == 1:
            raise OSError("planted: disk full")
        return real(*a, **k)
    monkeypatch.setattr(CKPT, "save", fails_once)
    with pytest.raises(OSError, match="planted"):
        _runner(n_iters=4, ckpt_dir=tmp_path, ckpt_every=2).run()
    monkeypatch.undo()
    assert steps == [2, 2] and CKPT.all_steps(tmp_path) == [2]
    manifest = json.loads(
        (tmp_path / "step_00000002" / "manifest.json").read_text())
    assert manifest["extra"]["emergency"] is True
    _, h_resume, _ = _runner(n_iters=2, ckpt_dir=tmp_path).run()
    _, h_free, _ = _runner(n_iters=4).run()
    assert [h["iter"] for h in h_resume] == [2, 3]
    assert _last(h_resume) == {i: x for i, x in _last(h_free).items()
                               if i >= 2}


def test_a_failed_emergency_save_does_not_mask_the_fault(tmp_path,
                                                          monkeypatch):
    """A save that fails itself (as after a sticky CUDA error) warns; the
    original exception goes on."""
    def broken_save(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(CKPT, "save", broken_save)
    chaos = FaultSchedule([FaultEvent(1, FaultKind.STAGE_CRASH, stage=0)])
    with pytest.warns(UserWarning, match="emergency checkpoint"):
        with pytest.raises(InjectedFault):
            _runner(n_iters=3, chaos=chaos, max_retries=0,
                    ckpt_dir=tmp_path).run()


def test_a_failure_inside_the_in_place_update_writes_no_checkpoint(
        tmp_path, monkeypatch):
    """AdamW overwrites the state leaf by leaf: a failure after its first
    leaf leaves the state torn between two steps, and must propagate
    without an emergency checkpoint of that state."""
    real = TO._update_leaf
    calls = []

    def fails_on_second_leaf(*a):
        calls.append(1)
        if len(calls) == 2:
            raise MemoryError("planted inside adamw_update")
        return real(*a)
    monkeypatch.setattr(TO, "_update_leaf", fails_on_second_leaf)
    runner = _runner(n_iters=2, ckpt_dir=tmp_path, ckpt_every=1)
    with pytest.warns(UserWarning, match="no emergency checkpoint"):
        with pytest.raises(MemoryError, match="planted"):
            runner.run()
    assert len(calls) == 2                  # the first leaf was updated
    assert CKPT.latest_step(tmp_path) is None


# ---------------------------------------------- runner: replica elastic --
def test_replica_death_shrinks_dp_and_matches_trajectory():
    clk = LogicalClock()
    mon = StragglerMonitor(2, heartbeat_timeout=2.0, window=4, clock=clk)
    chaos = FaultSchedule([FaultEvent(2, FaultKind.REPLICA_DEAD, replica=1)])
    r = _runner(n_iters=8, dp_size=2, chaos=chaos, monitor=mon)
    _, h_fault, s_fault = r.run()
    assert r.pcfg.dp_size == 1
    sweeps = [x for x in s_fault.recoveries
              if x["kind"] == "replica_set_change"]
    assert sweeps and sweeps[0]["dead_this_sweep"] == [1]
    assert sweeps[0]["alive"] == [0]
    _, h_free, _ = _runner(n_iters=8, dp_size=2).run()
    a = np.array([h["loss"] for h in h_fault], dtype=np.float64)
    b = np.array([h["loss"] for h in h_free], dtype=np.float64)
    assert len(a) == len(b) == 8
    np.testing.assert_allclose(a, b, rtol=1e-3)


def test_straggler_shifts_monitor_speed_factors():
    """A delay of 1 s on replica 1, against a replica's few ms at this
    size: a margin wide enough for a loaded machine. It falls on
    iterations 1 and 3, where the fixed split (no speed factors: the drift
    tolerance is out of reach) gives replica 1 work. Asserts only the
    order of the factors and the drift."""
    clk = LogicalClock()
    mon = StragglerMonitor(2, heartbeat_timeout=50.0, window=4, clock=clk)
    chaos = FaultSchedule([
        FaultEvent(i, FaultKind.STRAGGLER, stage=0, replica=1, delay_s=1.0)
        for i in (1, 3)])
    _runner(n_iters=4, dp_size=2, chaos=chaos, monitor=mon,
            drift_tolerance=1e9).run()
    assert not chaos.pending()              # both delays were served
    sf = mon.speed_factors()
    assert sf[0] == 1.0 > sf[1]
    assert mon.drift() > 1.1


def test_seeded_trace_end_to_end(tmp_path):
    """Straggler, planner loss, state-losing crash and replica death in one
    run: it completes, dp shrinks, and the last-occurrence trajectory
    tracks the fault-free one. The drift tolerance is out of reach: an
    idle replica (iteration 0 gives replica 1 no micro-batch) heartbeats
    an iteration time near 0 s, so past the default tolerance the measured
    speed factors reshape the split by wall time, and whether replica 0
    still has the micro-batch the crash is aimed at would depend on the
    machine's speed (ROADMAP C, records)."""
    clk = LogicalClock()
    mon = StragglerMonitor(2, heartbeat_timeout=2.0, window=4, clock=clk)
    chaos = FaultSchedule([
        FaultEvent(1, FaultKind.STRAGGLER, stage=0, replica=1, delay_s=0.05),
        FaultEvent(2, FaultKind.PLANNER_LOST),
        FaultEvent(3, FaultKind.STAGE_CRASH, stage=0, state_lost=True),
        FaultEvent(4, FaultKind.REPLICA_DEAD, replica=1),
    ])
    r = _runner(n_iters=9, dp_size=2, chaos=chaos, monitor=mon,
                ckpt_dir=tmp_path / "a", ckpt_every=2, plan_timeout=0.5,
                strict_verify=True, drift_tolerance=1e9)
    _, h_fault, s_fault = r.run()
    assert r.pcfg.dp_size == 1
    assert not chaos.pending()
    kinds = {x["kind"] for x in s_fault.recoveries}
    assert {"planner_resubmit", "checkpoint_restore",
            "replica_set_change"} <= kinds
    assert all(np.isfinite(h["loss"]) for h in h_fault)
    _, h_free, _ = _runner(n_iters=9, dp_size=2, ckpt_dir=tmp_path / "b",
                           ckpt_every=2, drift_tolerance=1e9).run()
    lf, lr = _last(h_fault), _last(h_free)
    assert sorted(lf) == sorted(lr) == list(range(9))
    np.testing.assert_allclose(np.array([lf[i][0] for i in range(9)]),
                               np.array([lr[i][0] for i in range(9)]),
                               rtol=1e-3)


# -------------------------------------------------- parity: reference --
def _trace(pkg):
    """The seeded end-to-end trace, as events of ``pkg``'s chaos module."""
    return pkg.FaultSchedule([
        pkg.FaultEvent(1, pkg.FaultKind.PLANNER_CRASH),
        pkg.FaultEvent(2, pkg.FaultKind.PLANNER_LOST),
        pkg.FaultEvent(3, pkg.FaultKind.STAGE_CRASH, stage=0,
                       state_lost=True),
        pkg.FaultEvent(4, pkg.FaultKind.REPLICA_DEAD, replica=1),
        pkg.FaultEvent(5, pkg.FaultKind.STAGE_CRASH, stage=0),
    ])


def _recovery_keys(stats):
    return [(r["kind"], r["iter"], r.get("restored_step"), r.get("alive"))
            for r in stats.recoveries]


def test_one_fault_schedule_recovers_as_the_reference_does(tmp_path):
    """Both runners under one schedule. Speed factors stay off (drift
    tolerance out of reach): with them the split follows each package's
    wall times, which differ (see test_seeded_trace_end_to_end). The plan
    timeout, which the lost plan waits out, leaves a plan made under load
    a wide margin, so that no other plan is resubmitted."""
    from repro_torch.dist import chaos as TC
    jchaos, tchaos = _trace(JC), _trace(TC)
    jclk, tclk = JC.LogicalClock(), LogicalClock()
    jr = _jrunner(7, dp_size=2, chaos=jchaos, ckpt_dir=tmp_path / "j",
                  ckpt_every=2, plan_timeout=2.0, drift_tolerance=1e9,
                  monitor=JMonitor(2, heartbeat_timeout=2.0, clock=jclk))
    _, jhist, jstats = jr.run()
    tr = _runner(n_iters=7, dp_size=2, chaos=tchaos, ckpt_dir=tmp_path / "t",
                 ckpt_every=2, plan_timeout=2.0, drift_tolerance=1e9,
                 monitor=StragglerMonitor(2, heartbeat_timeout=2.0,
                                          clock=tclk))
    _, thist, tstats = tr.run()
    assert _recovery_keys(tstats) == _recovery_keys(jstats)
    assert {"planner_resubmit", "checkpoint_restore", "replica_set_change",
            "retry"} <= {k for k, *_ in _recovery_keys(tstats)}
    assert [h["iter"] for h in thist] == [h["iter"] for h in jhist]
    assert [h["n_micro"] for h in thist] == [h["n_micro"] for h in jhist]
    assert tstats.faults == jstats.faults
    assert tr.pcfg.dp_size == jr.pcfg.dp_size == 1
    assert CKPT.all_steps(tmp_path / "t") == \
        CKPT.all_steps(tmp_path / "j")


def test_measured_speed_factors_shape_the_plan_as_in_the_reference():
    """Past the default drift tolerance, on scripted heartbeats: replica 1
    falls silent while replicas 0 and 2 report 1.0 s and 2.5 s an
    iteration on a logical clock. In both runners the topology sweep
    keeps [0, 2], ``_pcfg_now`` maps the measured factors through
    ``_alive`` to positions, and the plans split the batch alike: the
    slow replica's micro-batch of iteration 1 moves to the fast one."""
    from repro.core.planner import _plan_job as j_plan_job
    from repro.train.runner import RunnerStats as JStats
    from repro_torch.core.planner import _plan_job
    from repro_torch.train.runner import RunnerStats

    def drive(runner, stats, plan_job):
        mon = runner.monitor
        for _ in range(3):
            mon.clock.advance(1.0)
            mon.heartbeat(0, iter_time=1.0)
            mon.heartbeat(2, iter_time=2.5)
        runner._topology_sweep(0, stats)
        pcfg = runner._pcfg_now()
        lengths = runner._plan_lengths(runner.stream.batch(1))
        return pcfg, [[[(m.mbs, m.seq) for m in rp.micro_batches]
                       for rp in plan_job(lengths, runner.cost,
                                          p).replica_plans]
                      for p in (pcfg, dataclasses.replace(
                          pcfg, speed_factors=None))]

    jr = _jrunner(1, dp_size=3, monitor=JMonitor(
        3, heartbeat_timeout=2.0, clock=JC.LogicalClock()))
    tr = _runner(n_iters=1, dp_size=3, monitor=StragglerMonitor(
        3, heartbeat_timeout=2.0, clock=LogicalClock()))
    jp, jsplit = drive(jr, JStats(), j_plan_job)
    tp, tsplit = drive(tr, RunnerStats(), _plan_job)
    assert tr._alive == jr._alive == [0, 2]
    assert tp.dp_size == jp.dp_size == 2
    assert tr.monitor.drift() == jr.monitor.drift() == 2.5
    assert tp.speed_factors == jp.speed_factors == [1.0, 1.0 / 2.5]
    assert tsplit == jsplit
    measured, even = tsplit
    assert measured == [[(8, 128), (1, 32)], []]
    assert even == [[(8, 128)], [(1, 32)]]


def test_port_resumes_from_a_reference_checkpoint(tmp_path):
    """The reference trains 6 iterations writing steps 2, 4 and 6; the
    port restores step 4 and trains 4 and 5 as the reference did."""
    jcfg = dataclasses.replace(JCFG, dtype="float32")
    tcfg = dataclasses.replace(CFG, dtype="float32")
    _, jhist, _ = _jrunner(6, cfg=jcfg, ckpt_dir=tmp_path / "j",
                           ckpt_every=2).run()
    shutil.copytree(tmp_path / "j" / "step_00000004",
                    tmp_path / "t" / "step_00000004")
    _, thist, tstats = _runner(n_iters=2, cfg=tcfg, ckpt_dir=tmp_path / "t",
                               ckpt_every=2).run()
    assert [c["kind"] for c in tstats.checkpoints] == ["load", "save"]
    assert [h["iter"] for h in thist] == [4, 5]
    for t, j in zip(thist, jhist[4:]):
        assert (t["iter"], t["n_micro"], t["tokens"]) == \
            (j["iter"], j["n_micro"], j["tokens"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=F32_TOL)
    assert CKPT.all_steps(tmp_path / "t") == [4, 6]


# --------------------------------------------------------- the launcher --
def test_launcher_resumes_from_its_checkpoint_dir(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--reduced", "--stages", "1", "--tokens", "512",
           "--max-seq", "64", "--ckpt-dir", str(tmp_path), "--ckpt-every",
           "2", "--iters", "4"]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    outs = []
    for _ in range(2):
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, env=env)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout)
    assert "trained iterations 0-3" in outs[0]
    assert "trained iterations 4-7" in outs[1]
    assert CKPT.all_steps(tmp_path) == [4, 6, 8]

"""The port's process fault domain (``repro_torch.dist.cluster``) against
the reference's and against the port's in-process runner.

The reference's ``tests/test_process_cluster.py`` on the port, at its size
(reduced gpt-paper with 2 layers in float32, the same palette and stream):
the wire's frames are the reference's byte for byte; the port's gradient
trees cross it bit-exact; ``fault_domain="process"`` routes the runner
through the cluster; a SIGKILL mid-save leaves a recoverable checkpoint
directory. Then three real clusters of two worker processes: fault-free
(resumed from a checkpoint the reference wrote, and held to the
reference's trajectory within F32_TOL), the coordinator killed, and
replica 1 killed. A kill changes the plans (the survivors re-plan at
``dp_size=1``), so a killed run is held, to the bit, to the in-process
runner on the same plans: ``dp_size=2`` up to the first iteration the run
finished at ``dp_size=1``, then ``dp_size=1`` from that step's checkpoint.

Worker processes inherit ``OMP_NUM_THREADS=1``: one intra-op thread, as in
this process, so that their CPU sums are this process's and pytest-xdist's
workers are not oversubscribed. Kills are detected by socket EOF; the
heartbeat timeout is set long so that a loaded host's scheduling pause is
never taken for a death.
"""
import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
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
from repro.dist.cluster import _Conn as JConn
from repro.train.runner import PlanAheadRunner as JRunner
from repro.train.runner import RunnerConfig as JRunnerConfig
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.instructions import ExecutionPlan
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.dist import cluster as C
from repro_torch.dist.chaos import FaultEvent, FaultKind, FaultSchedule
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
from repro_torch.tree import flatten

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(reduced(get_arch("gpt-paper")), n_layers=2,
                          dtype="float32")
JCFG = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")), n_layers=2,
                           dtype="float32")
PAL = dict(min_seq=32, max_seq=128, seq_align=32, max_mbs=8)
STREAM = dict(n_tasks=8, global_tokens=512, max_len=128, vocab=CFG.vocab,
              seed=5)
F32_TOL = 2e-4
# the coordinator re-plans with measured speed factors past the drift
# tolerance; two processes on a loaded host drift, and an in-process
# oracle has no such timings: out of reach, the plans are the oracle's
NO_DRIFT = 1e9


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _pcfg(dp_size):
    return PlannerConfig(n_stages=1, dp_size=dp_size, d_model=CFG.d_model,
                         palette=ShapePalette.build(**PAL))


def _rcfg(n_iters, ckpt_dir="", ckpt_every=0, **kw):
    return RunnerConfig(n_iters=n_iters, use_executor=False, log_every=0,
                        ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                        drift_tolerance=NO_DRIFT, exec_timeout=30.0,
                        device="cpu", **kw)


def _cluster(tmp_path, n_iters, chaos=None, ckpt_dir="", ckpt_every=2):
    ccfg = C.ClusterConfig(n_replicas=2, heartbeat_timeout_s=30.0,
                           rundir=str(tmp_path / "run"))
    return C.run_process_cluster(
        CFG, AnalyticCostModel(CFG, n_stages=1), _pcfg(2),
        _rcfg(n_iters, ckpt_dir, ckpt_every), MultiTaskStream(
            StreamConfig(**STREAM)), chaos=chaos, ccfg=ccfg)


def _inprocess(n_iters, dp_size, ckpt_dir="", ckpt_every=0):
    return PlanAheadRunner(
        CFG, AnalyticCostModel(CFG, n_stages=1), _pcfg(dp_size),
        _rcfg(n_iters, ckpt_dir, ckpt_every),
        MultiTaskStream(StreamConfig(**STREAM))).run()


def _last(history) -> dict:
    """iter -> (loss, grad norm) of its last occurrence (a replay logs an
    iteration again)."""
    return {h["iter"]: (h["loss"], h["grad_norm"]) for h in history}


def _same_params(a, b) -> bool:
    fa, fb = list(flatten(a)), list(flatten(b))
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def _oracle(tmp_path, history, n_iters):
    """The in-process runs on the killed run's plans: ``dp_size=2`` for
    the iterations before the first one whose last occurrence ran at
    ``dp_size=1`` (``k``), then ``dp_size=1`` from step ``k``'s
    checkpoint. Returns (params, history, k)."""
    last = {h["iter"]: h for h in history}
    k = min((i for i, h in last.items() if h["dp_size"] == 1),
            default=n_iters)
    ckpt, hist, params = tmp_path / "oracle", [], None
    if k:
        params, h, _ = _inprocess(k, 2, ckpt_dir=ckpt, ckpt_every=k)
        hist += h
    if k < n_iters:
        params, h, _ = _inprocess(n_iters - k, 1,
                                  ckpt_dir=ckpt if k else "")
        hist += h
    return params, hist, k


def _check_clean(cl):
    assert cl["completed"], cl
    assert not cl["orphans"] and not cl["tmp_dirs_left"], cl
    shutil.rmtree(cl["rundir"], ignore_errors=True)


# ------------------------------------------------------------ wire frames --
def _raw(conn_cls, msg, blob):
    """The bytes ``conn_cls`` puts on a socketpair for one frame."""
    a, b = socket.socketpair()
    try:
        sender = threading.Thread(target=conn_cls(a).send, args=(msg, blob))
        sender.start()
        n = 8 + len(json.dumps(msg).encode()) + len(blob)
        got = bytearray()
        while len(got) < n:
            got += b.recv(n - len(got))
        sender.join()
        return bytes(got)
    finally:
        a.close()
        b.close()


def _through(sender_cls, reader_cls, msg, blob):
    a, b = socket.socketpair()
    try:
        sender = threading.Thread(target=sender_cls(a).send,
                                  args=(msg, blob))
        sender.start()
        out = reader_cls(b).recv()
        sender.join()
        return out
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("blob", [b"", b"\x00\x01binary",
                                  bytes(range(256)) * 1024],
                         ids=["no-blob", "short", "256KiB"])
def test_frames_are_the_references_byte_for_byte(blob):
    msg = {"type": "plan", "epoch": 3, "iter": 7, "loss_sum": 0.1 + 0.2,
           "plan": {"n_stages": 1, "meta": {"é": [1, 2.5]}}}
    assert _raw(C._Conn, msg, blob) == _raw(JConn, msg, blob)
    for sender, reader in ((C._Conn, JConn), (JConn, C._Conn)):
        got_msg, got_blob = _through(sender, reader, msg, blob)
        assert got_msg == msg and bytes(got_blob) == blob


def test_conn_closed_peer_raises_connection_error():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(ConnectionError):
        C._Conn(b).recv()
    b.close()


# --------------------------------------------------------- the tree wire --
def test_tree_wire_roundtrips_bit_exact():
    g = torch.Generator().manual_seed(0)
    f32 = torch.randn(5, 7, generator=g)
    f32[0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
    tree = {
        "stack": {"w": torch.randn(3, 4, 9, generator=g).bfloat16(),
                  "b": torch.randn(9, generator=g).bfloat16()},
        "head": f32,
        "t": torch.randn(6, 4, generator=g).t(),     # not contiguous
        "ids": {"i32": torch.arange(-5, 6, dtype=torch.int32),
                "i64": torch.tensor([[2**40, -1]], dtype=torch.int64)},
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4, dtype=torch.bfloat16),
        "step": 12,
    }
    blob = C._tree_to_bytes(tree)
    assert len(blob) % 64 == 0
    for src in (blob, bytes(blob)):        # a read-only buffer too
        back = C._tree_from_bytes(src)
        assert [p for p, _ in flatten(back)] == [p for p, _ in flatten(tree)]
        assert back["step"] == 12 and type(back["step"]) is int
        for (path, x), (_, y) in zip(flatten(tree), flatten(back)):
            if not isinstance(x, torch.Tensor):
                continue
            assert (y.dtype, y.shape, y.device.type) == \
                (x.dtype, x.shape, "cpu"), path
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[x.element_size()]
            assert torch.equal(y.contiguous().view(bits),
                               x.contiguous().view(bits)), path
    # the same tree gives the same bytes, padding included
    assert bytes(C._tree_to_bytes(tree)) == bytes(blob)
    # the decoded leaves are writable in place (the coordinator's merge),
    # and share the buffer's memory
    back = C._tree_from_bytes(blob)
    back["stack"]["w"].add_(tree["stack"]["w"])
    assert torch.equal(back["stack"]["w"], tree["stack"]["w"] * 2)
    assert torch.equal(C._tree_from_bytes(blob)["stack"]["w"],
                       back["stack"]["w"])


# --------------------------------------------------------- runner routing --
def test_runner_config_routes_process_fault_domain(monkeypatch):
    """fault_domain='process' bypasses the in-process loop entirely and
    hands the exact run configuration to the cluster launcher."""
    seen = {}

    def fake(cfg, cost, pcfg, rcfg, stream, opt_cfg=None, chaos=None,
             ccfg=None):
        seen.update(cfg=cfg, pcfg=pcfg, rcfg=rcfg, chaos=chaos,
                    opt_cfg=opt_cfg)
        return "params", ["history"], "stats"

    monkeypatch.setattr(C, "run_process_cluster", fake)
    pcfg = _pcfg(2)
    rcfg = RunnerConfig(n_iters=3, fault_domain="process", log_every=0,
                        device="cpu")
    chaos = FaultSchedule([])
    runner = PlanAheadRunner(CFG, AnalyticCostModel(CFG, n_stages=1), pcfg,
                             rcfg, MultiTaskStream(StreamConfig(**STREAM)),
                             chaos=chaos)
    assert runner.run() == ("params", ["history"], "stats")
    assert seen["rcfg"] is rcfg and seen["pcfg"] is pcfg
    assert seen["cfg"] is CFG and seen["chaos"] is chaos
    assert seen["opt_cfg"] is runner.opt_cfg
    with pytest.raises(ValueError, match="rcfg.seed"):
        PlanAheadRunner(CFG, None, pcfg, rcfg, None, params={})


def test_make_backend_process_points_at_cluster():
    from repro_torch.dist.backend import make_backend

    with pytest.raises(ValueError, match="fault_domain='process'"):
        make_backend("process", CFG, 1, device="cpu")


def test_process_backend_refuses_callbacks_and_hooks():
    backend = C.ProcessBackend(None, 0)
    plan = ExecutionPlan(n_stages=1, micro_batches=[], per_stage=[[]])
    with pytest.raises(ValueError, match="callback-driven"):
        backend.execute_plan(plan, callbacks=[object()])
    with pytest.raises(ValueError, match="hooks do not cross"):
        backend.execute_plan(plan, hook=lambda *a: None)


# ------------------------------------- torn-write recovery under SIGKILL --
def test_sigkill_mid_save_leaves_recoverable_dir(tmp_path):
    """SIGKILL a child mid-``save()``: the torn attempt never becomes a
    visible checkpoint (``load_latest_valid`` restores the previous step),
    and the next ``save()`` sweeps only the dead writer's tmp."""
    ckpt = tmp_path / "ckpt"
    marker = tmp_path / "MARKER"
    code = f"""
import time
import numpy as np
import torch
from repro_torch.train import checkpoint as CKPT

tree = {{"w0": torch.arange(16, dtype=torch.float32).reshape(4, 4),
         "w1": torch.ones(4, 4, dtype=torch.bfloat16)}}
CKPT.save({str(ckpt)!r}, 1, tree)
orig = np.save
def slow_save(path, arr):
    orig(path, arr)
    open({str(marker)!r}, "w").write("mid-save")
    time.sleep(600)
CKPT.np.save = slow_save
CKPT.save({str(ckpt)!r}, 2, {{"w0": tree["w0"] + 1, "w1": tree["w1"]}})
"""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    p = subprocess.Popen([sys.executable, "-c", code], env=env)
    try:
        deadline = time.monotonic() + 120
        while not marker.exists():
            assert time.monotonic() < deadline, "child never reached save(2)"
            assert p.poll() is None, "child died before the mid-save kill"
            time.sleep(0.02)
        os.kill(p.pid, signal.SIGKILL)
    finally:
        p.wait(timeout=30)

    torn = list(ckpt.glob(".tmp-2-*"))
    assert len(torn) == 1, "mid-save SIGKILL must leave the torn tmp behind"
    assert int(torn[0].name.split("-")[2]) == p.pid

    # the torn attempt never surfaced: the newest valid step is 1
    like = {"w0": torch.zeros(4, 4), "w1": torch.zeros(4, 4,
                                                       dtype=torch.bfloat16)}
    state, manifest = CKPT.load_latest_valid(ckpt, like)
    assert manifest["step"] == 1
    assert torch.equal(state["w0"],
                       torch.arange(16, dtype=torch.float32).reshape(4, 4))

    # the next save sweeps ONLY the dead writer's tmp dir
    live = ckpt / f".tmp-9-{os.getpid()}-cafecafe"
    live.mkdir()
    CKPT.save(ckpt, 3, state)
    assert not torn[0].exists(), "dead writer's torn tmp must be swept"
    assert live.exists(), "live writer's tmp must survive the sweep"
    assert CKPT.latest_step(ckpt) == 3


# ------------------------------------------------- the cluster, end to end --
def test_fault_free_cluster_resumes_a_reference_checkpoint(tmp_path):
    """The reference's in-process runner (dp 2) writes steps 1-3; the
    port's cluster restores step 1 and runs to 3. Held to the reference
    within F32_TOL, and to the port's in-process runner resumed from the
    same step to the bit."""
    jpcfg = JPlannerConfig(n_stages=1, dp_size=2, d_model=JCFG.d_model,
                           palette=JPalette.build(**PAL))
    jrcfg = JRunnerConfig(n_iters=3, use_executor=False, log_every=0,
                          ckpt_dir=str(tmp_path / "j"), ckpt_every=1,
                          exec_timeout=30.0, impl="ref")
    _, jhist, _ = JRunner(JCFG, JCost(JCFG, n_stages=1), jpcfg, jrcfg,
                          JStream(JStreamConfig(**STREAM))).run()
    for d in ("c", "t"):
        shutil.copytree(tmp_path / "j" / "step_00000001",
                        tmp_path / d / "step_00000001")

    params, hist, stats = _cluster(tmp_path, 3, ckpt_dir=tmp_path / "c")
    cl = stats.cluster
    events = C._read_jsonl(Path(cl["rundir"]) / C.EVENTS_FILE)
    _check_clean(cl)
    assert stats.mode == "process" and cl["final_alive"] == [0, 1]
    # one membership line, the bootstrap's: no false death on the way
    assert [e["kind"] for e in events if e["kind"] in (
        "membership", "replica_lost", "election")] == \
        ["election", "membership"]
    assert [e["resume"] for e in events if e["kind"] == "restore"] == [1]
    assert [h["iter"] for h in hist] == [1, 2]
    assert [h["dp_size"] for h in hist] == [2, 2]
    assert CKPT.all_steps(tmp_path / "c") == [1, 2, 3]

    tparams, thist, _ = _inprocess(2, 2, ckpt_dir=tmp_path / "t")
    assert _last(hist) == _last(thist)
    assert _same_params(params, tparams)
    for h, j in zip(hist, jhist[1:]):
        assert (h["iter"], h["n_micro"], h["tokens"], h["padded_tokens"]) \
            == (j["iter"], j["n_micro"], j["tokens"], j["padded_tokens"])
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(h["grad_norm"], j["grad_norm"],
                                   rtol=F32_TOL)
    # every iteration's gradients crossed the wire, both ways
    assert all(h["wire"]["bytes"] > 0 and h["wire"]["bcast_bytes"] > 0
               for h in hist)


def test_coordinator_sigkill_elects_successor_and_recovers(tmp_path):
    """kill -9 the coordinator's process mid-run: the surviving rank
    elects itself, restores from the shared checkpoint dir (or the seeded
    init), and ends equal to the in-process runner on the same plans."""
    n = 4
    chaos = FaultSchedule(
        [FaultEvent(1, FaultKind.KILL_PROCESS, target="coordinator")])
    params, hist, stats = _cluster(tmp_path, n, chaos=chaos)
    cl = stats.cluster
    events = C._read_jsonl(Path(cl["rundir"]) / C.EVENTS_FILE)
    _check_clean(cl)

    assert chaos.pending() == []
    assert len(cl["kills"]) == 1 and cl["kills"][0]["target"] == "coordinator"
    assert cl["kills"][0]["verified_dead"], \
        "the kill must leave a verified dead pid, not simulated silence"
    assert cl["elections"] >= 1, "coordinator death must trigger an election"
    assert cl["final_alive"] == [1]

    resume = [e["resume"] for e in events
              if e["kind"] == "restore" and e["epoch"] > 0][-1]
    oparams, ohist, k = _oracle(tmp_path, hist, n)
    assert k == resume
    assert sorted(_last(hist)) == list(range(n))
    assert _last(hist) == _last(ohist)
    assert _same_params(params, oparams)


def test_replica_sigkill_shrinks_to_the_survivor(tmp_path):
    """kill -9 replica 1: the coordinator loses it (socket EOF), re-plans
    at dp_size 1, and the run ends equal to the in-process runner on the
    same plans."""
    n = 4
    chaos = FaultSchedule([FaultEvent(2, FaultKind.KILL_PROCESS, replica=1)])
    params, hist, stats = _cluster(tmp_path, n, chaos=chaos)
    cl = stats.cluster
    events = C._read_jsonl(Path(cl["rundir"]) / C.EVENTS_FILE)
    _check_clean(cl)

    assert chaos.pending() == []
    assert len(cl["kills"]) == 1 and cl["kills"][0]["verified_dead"]
    assert cl["elections"] == 0 and cl["final_alive"] == [0]
    lost = [e for e in events if e["kind"] == "replica_lost"
            or (e["kind"] == "membership" and e.get("dead"))]
    assert lost and all(e.get("rank", 1) == 1 for e in lost)
    assert [e for e in events if e["kind"] == "membership"][-1]["dead"] == [1]

    oparams, ohist, k = _oracle(tmp_path, hist, n)
    assert 2 <= k < n
    assert [h["dp_size"] for h in hist if h["iter"] >= k] == [1] * (n - k)
    assert _last(hist) == _last(ohist)
    assert _same_params(params, oparams)

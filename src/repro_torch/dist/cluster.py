"""Process-per-replica fault domain: real corpses, real recovery.

Counterpart of ``repro.dist.cluster``. The in-process runner's recovery
loop (``train/runner.py``) survives faults simulated inside one process;
this module makes the fault domain real: one OS process per DP replica,
heartbeats over localhost TCP sockets, ``kill -9`` as the fault injector,
and the same invariant, a recovered run equal to an in-process run on the
same plans, across actual dead pids.

Topology
--------
``run_process_cluster`` (the *launcher*: a test, ``chip_smoke.py`` or
``PlanAheadRunner`` with ``RunnerConfig.fault_domain="process"``) spawns
``n_replicas`` worker processes with the spawn context (a CUDA context
cannot be forked). Every process is the same archetype, ``_Worker``; the
*coordinator role* attaches to the lowest live rank (rank 0 initially) as
extra threads inside that worker's process, so killing the coordinator
also kills a replica, the harshest failover case. On the card every
worker opens its own CUDA context on the same device: replicas share the
card, and no collective is needed, since gradients travel over the
sockets.

The coordinator:

- accepts worker connections and feeds their socket heartbeats into a
  :class:`~repro_torch.dist.fault.StragglerMonitor` (real clock:
  ``heartbeat_timeout_s`` wall seconds); socket EOF is the fast death
  signal (SIGKILL closes the peer's fds), the monitor catches hung-alive
  processes and supplies per-replica speed factors;
- plans each iteration over the survivors (``plan_iteration`` with
  ``dp_size=len(alive)``) and sends each replica its
  :class:`~repro_torch.core.instructions.ExecutionPlan` as JSON through one
  :class:`ProcessBackend` per rank (the ``ExecutionBackend`` protocol),
  with gradients and losses collected back over the wire;
- runs *epoch-numbered membership*: every membership change (a worker's
  socket dies, its heartbeats stop, or a coordinator is elected) bumps a
  monotonic epoch, re-published in ``coordinator.json``. Every message
  carries the epoch; stale workers' results and deposed coordinators'
  commands are fenced by key, and a half-collected iteration is simply
  re-planned over the survivors under the new epoch, which is safe
  because the optimizer step (the only irreversible action) is broadcast
  only after ALL survivors' gradients merged.

What is *not* transferred, and why that is safe: batches are never sent,
since ``stream.batch(k)`` is a pure function of ``(StreamConfig, k)``
(``data/streams.py``), so every worker rebuilds its micro-batches from the
integer ``k`` alone. Params are never sent either: all replicas start from
the same seeded init (a ``torch.Generator`` on ``rcfg.device``, as the
in-process runner draws it), apply the same merged gradient with the same
in-place AdamW update, and therefore stay bit-identical. The merge sums
the replicas' gradients in ascending rank, leaf by leaf in their own
dtype, as the in-process runner's ``tree.add_into`` does, so a cluster run
equals an in-process run on the same plans to the bit.

Coordinator election: when a worker's connection dies and
``coordinator.json``'s pid is a verified corpse, the lowest-rank survivor
(by signal-0 probe of the ``worker-{rank}.json`` registry) claims the next
epoch via an ``O_EXCL`` lock file, starts the coordinator role in-process,
and re-publishes ``coordinator.json``. The new coordinator restores the
whole cluster from the shared CRC-verified checkpoint directory
(``train/checkpoint.load_latest_valid``, in place into the live tensors)
or the fresh seeded init when none exists, and resumes planning from that
step with deterministic stream replay.

Fault injection: the launcher polls ``history.jsonl`` for progress and
delivers :class:`~repro_torch.dist.chaos.FaultKind.KILL_PROCESS` events as
real ``os.kill(pid, SIGKILL)``, verifying each target is an actual dead
pid before recording the kill.

Wire protocol: length-prefixed frames over localhost TCP, the reference's
byte for byte: an 8-byte header (u32 json length, u32 blob length,
big-endian), a UTF-8 JSON control message, and an optional binary blob.
A gradient blob is the port's own tree format (:func:`_tree_to_bytes`):
dtype-preserving and bit-exact, bf16 by its 16-bit pattern, one copy off
the card per tree. The sockets only ever connect spawned children of one
trusted local launcher.

Kernel launches are counted per process (``kernels.ops``), so each worker
rewrites ``stats-{rank}.json`` (its launch counts and peak device memory)
after every plan it runs; a killed worker's file keeps what it ran.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import signal
import socket
import struct
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.chaos import FaultSchedule, deliver_kill
from repro_torch.dist.fault import StragglerMonitor
from repro_torch.tree import add_into, flatten, tree_map, unflatten

COORD_FILE = "coordinator.json"
HISTORY_FILE = "history.jsonl"
EVENTS_FILE = "events.jsonl"
RESULT_FILE = "result.json"


@dataclass(frozen=True)
class ClusterConfig:
    """Knobs of the process fault domain (everything else rides in the
    same ``ArchConfig``/``PlannerConfig``/``RunnerConfig`` the in-process
    runner uses)."""

    n_replicas: int = 2
    host: str = "127.0.0.1"
    heartbeat_interval_s: float = 0.1
    heartbeat_timeout_s: float = 2.0     # wall seconds of silence = dead
    connect_timeout_s: float = 60.0      # worker boot / reconnect budget
    result_timeout_s: float = 120.0      # per-iteration gradient collect
    election_poll_s: float = 0.05
    election_timeout_s: float = 60.0
    run_timeout_s: float = 600.0         # launcher's hard wall clock
    rundir: str = ""                     # "" = private tempdir


class WorkerDied(RuntimeError):
    """A replica's socket died or its heartbeats stopped mid-collect."""

    def __init__(self, rank: int, why: str):
        super().__init__(f"worker {rank} died: {why}")
        self.rank = rank


# ---------------------------------------------------------------------------
# small file/pid helpers (shared by launcher, coordinator, workers)
# ---------------------------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _atomic_json(path: Path, obj: dict) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def _read_json(path: Path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _append_jsonl(path: Path, obj: dict) -> None:
    # O_APPEND single-write lines: atomic enough for the one-live-writer-
    # at-a-time (plus short post-SIGKILL overlap) discipline used here
    with open(path, "a") as f:
        f.write(json.dumps(obj) + "\n")


def _read_jsonl(path: Path) -> list[dict]:
    out = []
    try:
        text = path.read_text()
    except OSError:
        return out
    for line in text.splitlines():
        with contextlib.suppress(json.JSONDecodeError):
            out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# the tree wire format
# ---------------------------------------------------------------------------

_ALIGN = 64     # every leaf's bytes start on this boundary


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _tree_to_bytes(tree) -> memoryview:
    """A nested dict of tensors (and ``int`` leaves) -> one buffer: an
    8-byte big-endian index length, the JSON index (per leaf its path,
    dtype name and shape and its data offset, or an ``int``'s value), zero
    padding to a 64-byte boundary, then each tensor's raw bytes at its
    64-aligned offset (bf16 as its 16-bit pattern, as every dtype: the
    bytes of the tensor). Leaves on the card are copied into one pinned
    host buffer with one device synchronise for the whole tree."""
    index, parts, off = [], [], 0
    for path, x in flatten(tree):
        if isinstance(x, torch.Tensor):
            n = x.numel() * x.element_size()
            index.append({"path": list(path),
                          "dtype": str(x.dtype).removeprefix("torch."),
                          "shape": list(x.shape), "offset": off})
            parts.append((off, n, x))
            off = _aligned(off + n)
        elif isinstance(x, int) and not isinstance(x, bool):
            index.append({"path": list(path), "int": int(x)})
        else:
            raise TypeError(f"tree leaves are tensors or ints, not "
                            f"{type(x).__name__}")
    head = json.dumps(index).encode()
    start = _aligned(8 + len(head))
    cuda = any(x.is_cuda for _, _, x in parts)
    out = torch.empty(start + off, dtype=torch.uint8, pin_memory=cuda)
    arr = out.numpy()
    arr[:start] = 0
    arr[:8] = np.frombuffer(struct.pack(">Q", len(head)), np.uint8)
    arr[8:8 + len(head)] = np.frombuffer(head, np.uint8)
    with torch.no_grad():
        for o, n, x in parts:
            lo = start + o
            if n:
                out[lo:lo + n].copy_(
                    x.detach().contiguous().view(-1).view(torch.uint8),
                    non_blocking=x.is_cuda)
            arr[lo + n:start + _aligned(o + n)] = 0
    if cuda:
        torch.cuda.synchronize()    # the one wait for the whole tree
    return memoryview(arr)


def _tree_from_bytes(blob, device=None):
    """The tree of :func:`_tree_to_bytes`' buffer: CPU tensors that share
    the buffer's memory (a read-only buffer is copied first), or with
    ``device`` one copy of the whole data section to it, the leaves views
    into that copy."""
    buf = blob if not memoryview(blob).readonly else bytearray(blob)
    mv = memoryview(buf).cast("B")
    (n_head,) = struct.unpack(">Q", mv[:8])
    index = json.loads(bytes(mv[8:8 + n_head]))
    start = _aligned(8 + n_head)
    data = torch.frombuffer(buf, dtype=torch.uint8)[start:]
    if device is not None and torch.device(device).type != "cpu":
        data = data.to(device)
    pairs = []
    for e in index:
        path = tuple(e["path"])
        if "int" in e:
            pairs.append((path, int(e["int"])))
            continue
        dt = getattr(torch, e["dtype"])
        n = math.prod(e["shape"]) * torch.empty((), dtype=dt).element_size()
        o = e["offset"]
        pairs.append((path, data[o:o + n].view(dt).reshape(e["shape"])))
    return unflatten(pairs)


# ---------------------------------------------------------------------------
# framed-message connection
# ---------------------------------------------------------------------------

class _Conn:
    """One framed-message TCP connection. ``send`` is thread-safe (the
    heartbeat thread and the serving loop share it); ``recv`` has a single
    reader by construction. A blob is any bytes-like object; it goes out
    after the header without being copied into one frame, and comes in as
    a writable ``bytearray``."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._slock = threading.Lock()

    def send(self, msg: dict, blob=b"") -> None:
        data = json.dumps(msg).encode()
        blob = memoryview(blob).cast("B")
        head = struct.pack(">II", len(data), len(blob)) + data
        with self._slock:
            self.sock.sendall(head)
            if len(blob):
                self.sock.sendall(blob)

    def _recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self.sock.recv_into(view[got:])
            if not k:
                raise ConnectionError("peer closed")
            got += k
        return buf

    def recv(self) -> tuple[dict, bytes]:
        lj, lb = struct.unpack(">II", self._recv_exact(8))
        msg = json.loads(self._recv_exact(lj).decode())
        blob = self._recv_exact(lb) if lb else b""
        return msg, blob

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self.sock.close()


# ---------------------------------------------------------------------------
# ProcessBackend: the ExecutionBackend protocol over the wire
# ---------------------------------------------------------------------------

class ProcessBackend:
    """``ExecutionBackend`` over a socket to one replica process.

    ``execute_plan`` ships the plan's JSON (iteration + epoch ride in
    ``plan.meta``) and blocks until that worker's gradients return as a
    :class:`~repro_torch.dist.backend.BackendResult` (CPU tensors; its
    ``meta`` carries the wire's timings). ``params``/``batches`` are
    deliberately NOT shipped: the worker owns its replicated params, and
    rebuilds the batch from the deterministic stream. ``optimizer_step``
    broadcasts the merged gradient to every live replica (each applies the
    identical AdamW update locally): the coordinator's whole data plane
    goes through this class, which is what routes
    ``RunnerConfig.fault_domain="process"`` through the backend API.
    """

    name = "process"

    def __init__(self, coord: "_Coordinator", rank: int):
        self.coord = coord
        self.rank = rank

    def execute_plan(self, plan, *, params=None, batches=None, callbacks=None,
                     hook=None, collect_timings: bool = False,
                     timeout: Optional[float] = None):
        from repro_torch.dist.backend import BackendResult

        if callbacks is not None:
            raise ValueError("the process backend ships plans to worker "
                             "processes; callback-driven execution is the "
                             "threads backend's host plane")
        if hook is not None:
            raise ValueError("the process fault domain injects real process "
                             "faults (chaos KILL_PROCESS via the launcher); "
                             "executor hooks do not cross process boundaries")
        it = int(plan.meta["iteration"])
        ep = int(plan.meta["epoch"])
        self.coord.send_to(self.rank, {
            "type": "plan", "epoch": ep, "iter": it,
            "collect_timings": bool(collect_timings),
            "plan": plan.to_json()})
        msg, blob = self.coord.await_msg(
            "result", ep, it, self.rank,
            timeout if timeout is not None
            else self.coord.ccfg.result_timeout_s)
        t0 = time.perf_counter()
        grads = _tree_from_bytes(blob) if blob else None
        meta = {"bytes": len(blob), "to_bytes_s": msg["to_bytes_s"],
                "socket_s": msg["t_recv"] - msg["t_sent"],
                "from_bytes_s": time.perf_counter() - t0}
        return BackendResult(grads, float(msg["loss_sum"]),
                             float(msg["weight_sum"]),
                             [tuple(t) for t in msg.get("timings") or []],
                             meta)

    def place_opt_state(self, opt_state):
        return opt_state    # workers own (and place) their own opt state

    def optimizer_step(self, params, grads, opt_state, opt_cfg):
        """Broadcast the merged (unscaled) grads + scale; every surviving
        worker applies the same deterministic AdamW update locally."""
        gnorm = self.coord.broadcast_step(grads)
        return params, opt_state, {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# coordinator role
# ---------------------------------------------------------------------------

def _plan_lengths(gb):
    L = gb.lengths
    return L[:, 0] if not np.any(L[:, 1]) else L


class _Coordinator:
    """The planning/membership brain; lives as threads inside the lowest
    live rank's worker process. It never touches the card: gradients are
    merged on the host."""

    def __init__(self, rundir: Path, epoch: int, payload: dict, rank: int):
        self.rundir = rundir
        self.payload = payload
        self.cfg = payload["cfg"]
        self.cost = payload["cost"]
        self.pcfg = payload["pcfg"]
        self.rcfg = payload["rcfg"]
        self.stream = payload["stream"]
        self.ccfg: ClusterConfig = payload["ccfg"]
        self.n = self.ccfg.n_replicas
        self.epoch = epoch
        self.rank = rank
        self.elected = epoch > 0

        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.conns: dict[int, _Conn] = {}
        self.sock_dead: set[int] = set()
        self.inbox: dict[tuple, tuple] = {}
        self.monitor = StragglerMonitor(
            self.n, heartbeat_timeout=self.ccfg.heartbeat_timeout_s)
        self.scale_pending: Optional[dict] = None
        self.wire: dict = {}             # the last broadcast's timings
        self.save_s = 0.0                # and the last step's save

        self.srv = socket.create_server((self.ccfg.host, 0), backlog=self.n + 2)
        self.port = self.srv.getsockname()[1]
        self._publish()
        self._event({"kind": "coordinator_start", "rank": rank,
                     "pid": os.getpid(), "elected": self.elected})
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="coord-accept").start()

    # --------------------------- bookkeeping ---------------------------
    def _publish(self) -> None:
        _atomic_json(self.rundir / COORD_FILE, {
            "epoch": self.epoch, "rank": self.rank, "pid": os.getpid(),
            "port": self.port})

    def _event(self, obj: dict) -> None:
        _append_jsonl(self.rundir / EVENTS_FILE,
                      dict(obj, epoch=self.epoch, t=time.time()))

    # ----------------------------- sockets -----------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self.srv.accept()
            except OSError:
                return       # server closed at shutdown
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._reader, args=(_Conn(sock),),
                             daemon=True, name="coord-reader").start()

    def _reader(self, conn: _Conn) -> None:
        rank = None
        try:
            msg, _ = conn.recv()
            if msg.get("type") != "hello":
                conn.close()
                return
            rank = int(msg["rank"])
            with self.cv:
                self.conns[rank] = conn
                self.sock_dead.discard(rank)
                self.monitor.heartbeat(rank)
                self.cv.notify_all()
            while True:
                msg, blob = conn.recv()
                msg["t_recv"] = time.time()
                t = msg["type"]
                if t == "heartbeat":
                    self.monitor.heartbeat(rank)
                    continue
                key = (t, int(msg["epoch"]), int(msg["iter"]), rank)
                if t == "result" and msg.get("iter_time") is not None:
                    self.monitor.heartbeat(rank, iter_time=msg["iter_time"])
                with self.cv:
                    self.inbox[key] = (msg, blob)
                    self.cv.notify_all()
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            if rank is not None:
                with self.cv:
                    if self.conns.get(rank) is conn:
                        del self.conns[rank]
                        self.sock_dead.add(rank)
                    self.cv.notify_all()

    def send_to(self, rank: int, msg: dict, blob=b"") -> None:
        with self.lock:
            conn = self.conns.get(rank)
        if conn is None:
            raise WorkerDied(rank, "no live connection")
        try:
            conn.send(msg, blob)
        except (ConnectionError, OSError) as e:
            with self.cv:
                if self.conns.get(rank) is conn:
                    del self.conns[rank]
                    self.sock_dead.add(rank)
                self.cv.notify_all()
            raise WorkerDied(rank, f"send failed: {e!r}") from e

    def await_msg(self, type_: str, epoch: int, it: int, rank: int,
                  timeout: float) -> tuple[dict, bytes]:
        key = (type_, epoch, it, rank)
        deadline = time.monotonic() + timeout
        with self.cv:
            while True:
                if key in self.inbox:
                    return self.inbox.pop(key)
                if rank in self.sock_dead:
                    raise WorkerDied(rank, "socket closed")
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self.cv.wait(min(left, 0.25))
        # timed out: a hung-but-connected worker is declared dead by the
        # heartbeat monitor, a slow-but-alive one is a hard cluster error
        if rank not in self.monitor.alive():
            with self.cv:
                self.sock_dead.add(rank)
                self.cv.notify_all()
            raise WorkerDied(rank, "heartbeat timeout")
        raise TimeoutError(
            f"worker {rank} still heartbeats but produced no {type_} for "
            f"iteration {it} within {timeout}s")

    # --------------------------- membership ----------------------------
    def _registry_live(self) -> set[int]:
        live = set()
        for r in range(self.n):
            info = _read_json(self.rundir / f"worker-{r}.json")
            if info is None:
                # bootstrap: every rank was just spawned, a missing file
                # means still booting — wait for it. Post-election the
                # registry is complete, so missing == never existed.
                if not self.elected:
                    live.add(r)
            elif _pid_alive(int(info["pid"])):
                live.add(r)
        return live

    def _wait_members(self) -> list[int]:
        deadline = time.monotonic() + self.ccfg.connect_timeout_s
        while time.monotonic() < deadline:
            expected = self._registry_live()
            with self.lock:
                have = set(self.conns)
            if expected and expected <= have:
                break
            time.sleep(self.ccfg.election_poll_s)
        with self.lock:
            return sorted(self.conns)

    def _alive_now(self) -> list[int]:
        hb = set(self.monitor.alive())
        with self.lock:
            return sorted((set(self.conns) - self.sock_dead) & hb)

    # --------------------------- data plane ----------------------------
    def broadcast_step(self, grads) -> float:
        """Send merged grads + scale + checkpoint duty to every survivor;
        collect acks. Once this starts the iteration is committed: a rank
        that fails to ack is declared dead and leaves the membership, but
        the survivors all applied the identical update."""
        st = self.scale_pending
        assert st is not None, "broadcast_step outside an iteration"
        t0 = time.time()
        blob = _tree_to_bytes(grads) if grads is not None else b""
        alive = list(st["alive"])
        saver = min(alive)
        for rank in alive:
            with contextlib.suppress(WorkerDied):
                self.send_to(rank, {
                    "type": "step", "epoch": st["epoch"], "iter": st["iter"],
                    "scale": st["scale"],
                    "save": bool(st["save"]) and rank == saver}, blob)
        gnorm = float("nan")
        acks = []
        for rank in alive:
            with contextlib.suppress(WorkerDied):
                msg, _ = self.await_msg("step_ok", st["epoch"], st["iter"],
                                        rank, self.ccfg.result_timeout_s)
                acks.append(msg)
                if rank == saver:
                    gnorm = float(msg["grad_norm"])
        # from the start of the merged tree's serialisation to the last
        # replica holding all of it; then its copy to the card
        self.wire = {
            "bcast_bytes": len(blob) * len(alive),
            "bcast_s": max((m["t_got"] for m in acks), default=t0) - t0,
            "h2d_s": max((m["h2d_s"] for m in acks), default=0.0)}
        self.save_s = max((m["save_s"] for m in acks), default=0.0)
        return gnorm

    def _restore_round(self, alive: list[int]) -> int:
        """Reset every survivor to the newest CRC-valid shared checkpoint
        (or fresh deterministic init) so the cluster resumes from one
        consistent step. Mandatory after election: a coordinator death
        between partial step broadcasts may have left replicas divergent."""
        ep = self.epoch
        for r in alive:
            self.send_to(r, {"type": "restore", "epoch": ep, "iter": -1})
        resumes = []
        for r in alive:
            msg, _ = self.await_msg("restore_ok", ep, -1, r,
                                    self.ccfg.result_timeout_s)
            resumes.append(int(msg["resume"]))
        resume = min(resumes) if resumes else 0
        self._event({"kind": "restore", "resume": resume,
                     "resumes": resumes, "alive": alive})
        return resume

    # ---------------------------- main loop ----------------------------
    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:    # noqa: BLE001 — reporting path
            self._event({"kind": "coordinator_error", "err": repr(e),
                         "tb": traceback.format_exc()})
            raise
        finally:
            with contextlib.suppress(OSError):
                self.srv.close()

    def _run(self) -> None:
        rcfg, pcfg = self.rcfg, self.pcfg
        from repro_torch.core.planner import plan_iteration

        alive = self._wait_members()
        if not alive:
            raise RuntimeError("no workers connected")
        prev_alive = list(alive)
        self._event({"kind": "membership", "alive": alive, "iter": -1})
        it = self._restore_round(alive)
        # the absolute iteration count, as the reference's cluster runs it
        # (the in-process runner runs n_iters more from its restored step)
        end = rcfg.n_iters
        backends = {r: ProcessBackend(self, r) for r in range(self.n)}
        pool = ThreadPoolExecutor(max_workers=max(2, self.n),
                                  thread_name_prefix="coord-dispatch")
        try:
            while it < end:
                alive = self._alive_now()
                if alive != prev_alive:
                    self.epoch += 1
                    self._publish()
                    self._event({
                        "kind": "membership", "iter": it, "alive": alive,
                        "dead": sorted(set(prev_alive) - set(alive)),
                        "joined": sorted(set(alive) - set(prev_alive))})
                    prev_alive = list(alive)
                if not alive:
                    raise RuntimeError(
                        f"iteration {it}: all replicas dead")
                t0 = time.perf_counter()
                gb = self.stream.batch(it)
                p = dataclasses.replace(pcfg, dp_size=len(alive))
                if len(alive) > 1 and \
                        self.monitor.drift() > rcfg.drift_tolerance:
                    sf = self.monitor.speed_factors()
                    p = dataclasses.replace(
                        p, speed_factors=[sf[r] for r in alive])
                it_plan = plan_iteration(_plan_lengths(gb), self.cost, p)

                ep = self.epoch
                futs = {}
                for pos, rank in enumerate(alive):
                    rp = it_plan.replica_plans[pos]
                    rp.meta["iteration"] = it
                    rp.meta["epoch"] = ep
                    futs[rank] = pool.submit(backends[rank].execute_plan, rp)
                try:
                    results = {r: f.result() for r, f in futs.items()}
                except WorkerDied as e:
                    # membership changed mid-collect: the epoch bump at the
                    # top of the loop fences every partial result (inbox
                    # keys carry the old epoch) and the same iteration is
                    # re-planned over the survivors — no optimizer step
                    # ran, so replay is exact
                    self._event({"kind": "replica_lost", "iter": it,
                                 "rank": e.rank, "why": str(e)})
                    continue

                metas = [results[r].meta for r in alive]
                t_merge = time.perf_counter()
                grads, loss_sum, w_sum = None, 0.0, 0.0
                for rank in alive:         # ascending: deterministic merge
                    res = results[rank]
                    loss_sum += res.loss_sum
                    w_sum += res.weight_sum
                    if res.grads is not None:
                        grads = res.grads if grads is None else \
                            _tree_add(grads, res.grads)
                merge_s = time.perf_counter() - t_merge
                scale = 1.0 / max(w_sum, 1.0)
                save = bool(
                    rcfg.ckpt_every
                    and (it + 1) % rcfg.ckpt_every == 0) or it == end - 1
                self.scale_pending = {"epoch": ep, "iter": it, "alive": alive,
                                      "scale": scale, "save": save}
                _, _, om = backends[min(alive)].optimizer_step(
                    None, grads, None, None)
                self.scale_pending = None
                del grads, results, futs

                dt = time.perf_counter() - t0
                padded = sum(
                    m.mbs * (sum(m.seq) if isinstance(m.seq, (tuple, list))
                             else m.seq)
                    for rp in it_plan.replica_plans
                    for m in rp.micro_batches)
                _append_jsonl(self.rundir / HISTORY_FILE, {
                    "epoch": ep, "iter": it,
                    "loss": loss_sum / max(w_sum, 1.0),
                    "time_s": dt,
                    "n_micro": sum(len(rp.micro_batches)
                                   for rp in it_plan.replica_plans),
                    "grad_norm": om["grad_norm"],
                    "dp_size": len(alive),
                    "tokens": gb.total_tokens,
                    "padded_tokens": int(padded),
                    "t": time.time(),
                    "save_s": self.save_s,     # inside time_s
                    # the gradients' trip: each replica's copy off the card
                    # into its frame, the socket, the decode and sum here,
                    # the merged tree's broadcast and its copy to the card
                    "wire": {
                        "bytes": sum(m["bytes"] for m in metas),
                        "to_bytes_s": max(m["to_bytes_s"] for m in metas),
                        "socket_s": max(m["socket_s"] for m in metas),
                        "merge_s": merge_s + max(m["from_bytes_s"]
                                                 for m in metas),
                        **self.wire},
                })
                it += 1

            _atomic_json(self.rundir / RESULT_FILE, {
                "completed": True, "iters": end, "epoch": self.epoch,
                "final_alive": prev_alive, "coordinator_rank": self.rank,
                "elected": self.elected})
            with self.lock:
                conns = dict(self.conns)
            for _rank, conn in sorted(conns.items()):
                with contextlib.suppress(ConnectionError, OSError):
                    conn.send({"type": "shutdown", "epoch": self.epoch,
                               "iter": end})
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def _tree_add(a, b):
    """``a + b`` leaf by leaf, in place into ``a``, in ``a``'s dtype: the
    in-process runner's merge (``tree.add_into``)."""
    return add_into(a, b)


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

class _Worker:
    """One DP replica: owns a full replicated copy of params + opt state,
    executes shipped plans over locally-rebuilt batches, applies broadcast
    merged gradients, and participates in coordinator election."""

    def __init__(self, rundir: Path, rank: int, payload: dict):
        from repro_torch.device import resolve_device
        from repro_torch.dist.backend import ThreadsBackend

        self.rundir = rundir
        self.rank = rank
        self.payload = payload
        self.cfg = payload["cfg"]
        self.pcfg = payload["pcfg"]
        self.rcfg = payload["rcfg"]
        self.opt_cfg = payload["opt_cfg"]
        self.stream = payload["stream"]
        self.ccfg: ClusterConfig = payload["ccfg"]
        self.ckpt_dir = self.rcfg.ckpt_dir
        self.device = resolve_device(self.rcfg.device)
        # -1 so the bootstrap claim (no coordinator.json yet) lands on
        # epoch 0; every real election claims a strictly positive epoch
        self.epoch_seen = -1
        self.done = False
        self.coordinator: Optional[_Coordinator] = None
        self._coord_dead_pids: set[int] = set()
        self._connect_fails: dict[tuple, int] = {}
        self._t0 = time.monotonic()

        self.backend = ThreadsBackend(
            self.cfg, self.pcfg.n_stages,
            use_executor=self.rcfg.use_executor,
            exec_timeout=self.rcfg.exec_timeout, device=self.device)
        self.params, self.opt = self._fresh_state()
        _atomic_json(rundir / f"worker-{rank}.json",
                     {"rank": rank, "pid": os.getpid()})

    def _fresh_state(self):
        """Seed-deterministic init, drawn as ``PlanAheadRunner.run`` draws
        it: identical in every process on one device type, so replicas
        start (and, under identical updates, stay) bit-identical."""
        from repro_torch.models import model as MD
        from repro_torch.models import transformer as T
        from repro_torch.train.optimizer import init_opt_state

        gen = torch.Generator(device=self.device).manual_seed(self.rcfg.seed)
        init = T.init_encdec if self.cfg.family == "encdec" \
            else MD.init_params
        params = init(gen, self.cfg, device=self.device)
        return params, init_opt_state(params, self.opt_cfg)

    def _write_stats(self) -> None:
        """This process's kernel launches and peak device memory, for the
        launcher (counts are per process)."""
        from repro_torch.kernels import ops

        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        _atomic_json(self.rundir / f"stats-{self.rank}.json", {
            "launches": ops.launch_counts(), "peak_bytes": int(peak)})

    # ------------------------ election / discovery ---------------------
    def _live_ranks(self) -> list[int]:
        """Ranks presumed alive from the registry. A rank whose file
        exists but whose pid is dead is a corpse; a rank with NO file yet
        is *still booting* during the initial connect window (registry
        files are written before first connect, so a boot race must not
        let a higher rank win the bootstrap election from rank 0) and only
        counts as dead once that window has passed."""
        booting = (time.monotonic() - self._t0) < self.ccfg.connect_timeout_s
        live = []
        for r in range(self.ccfg.n_replicas):
            info = _read_json(self.rundir / f"worker-{r}.json")
            if info is None:
                if booting:
                    live.append(r)
            elif _pid_alive(int(info["pid"])):
                live.append(r)
        return live

    def _claim_epoch(self, epoch: int) -> bool:
        path = self.rundir / f".claim-{epoch}"
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            claimant = _read_json(path)
            if claimant and not _pid_alive(int(claimant.get("pid", -1))):
                # the claimant died between claim and publish: release
                with contextlib.suppress(OSError):
                    os.unlink(path)
            return False
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps({"pid": os.getpid(), "rank": self.rank}))
        return True

    def _locate_coordinator(self) -> dict:
        """Find a live coordinator to serve, or become one: the lowest
        live registry rank claims ``epoch+1`` and starts the role
        in-process (the deterministic election rule)."""
        deadline = time.monotonic() + self.ccfg.election_timeout_s
        while time.monotonic() < deadline and not self.done:
            info = _read_json(self.rundir / COORD_FILE)
            if info and int(info["pid"]) not in self._coord_dead_pids \
                    and _pid_alive(int(info["pid"])):
                return info
            survivors = self._live_ranks()
            if survivors and survivors[0] == self.rank:
                epoch = max(self.epoch_seen,
                            int(info["epoch"]) if info else -1) + 1
                if self._claim_epoch(epoch):
                    coord = _Coordinator(self.rundir, epoch,
                                         self.payload, self.rank)
                    self.coordinator = coord
                    threading.Thread(target=coord.run, daemon=True,
                                     name="coordinator").start()
                    _append_jsonl(self.rundir / EVENTS_FILE, {
                        "kind": "election", "epoch": epoch,
                        "rank": self.rank, "pid": os.getpid(),
                        "t": time.time()})
                    return {"epoch": epoch, "rank": self.rank,
                            "pid": os.getpid(), "port": coord.port}
            time.sleep(self.ccfg.election_poll_s)
        if self.done:
            return {}
        raise TimeoutError(
            f"worker {self.rank}: no coordinator found/elected within "
            f"{self.ccfg.election_timeout_s}s")

    # ----------------------------- serving -----------------------------
    def run(self) -> None:
        while not self.done:
            info = self._locate_coordinator()
            if self.done:
                return
            try:
                self._serve(info)
            except (ConnectionError, OSError) as e:
                key = (int(info["pid"]), int(info["port"]))
                self._connect_fails[key] = self._connect_fails.get(key, 0) + 1
                if self._connect_fails[key] >= 3 \
                        or not _pid_alive(int(info["pid"])):
                    # verified (or thrice-presumed) corpse: stop retrying
                    # it and let the election path take over
                    self._coord_dead_pids.add(int(info["pid"]))
                print(f"worker {self.rank}: coordinator connection lost "
                      f"({e!r}); rediscovering", flush=True)
                time.sleep(self.ccfg.election_poll_s)

    def _serve(self, info: dict) -> None:
        sock = socket.create_connection(
            (self.ccfg.host, int(info["port"])),
            timeout=self.ccfg.connect_timeout_s)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock)
        conn.send({"type": "hello", "rank": self.rank, "pid": os.getpid()})
        self._connect_fails.pop((int(info["pid"]), int(info["port"])), None)
        stop_hb = threading.Event()

        def heartbeat():
            while not stop_hb.wait(self.ccfg.heartbeat_interval_s):
                try:
                    conn.send({"type": "heartbeat", "rank": self.rank})
                except (ConnectionError, OSError):
                    return

        threading.Thread(target=heartbeat, daemon=True,
                         name=f"hb-{self.rank}").start()
        try:
            while True:
                msg, blob = conn.recv()
                ep = int(msg.get("epoch", 0))
                if ep < self.epoch_seen:
                    continue     # fenced: a deposed coordinator's command
                self.epoch_seen = ep
                t = msg["type"]
                if t == "plan":
                    self._do_plan(conn, msg)
                elif t == "step":
                    self._do_step(conn, msg, blob)
                elif t == "restore":
                    self._do_restore(conn, msg)
                elif t == "shutdown":
                    self.done = True
                    return
        finally:
            stop_hb.set()
            conn.close()

    def _do_plan(self, conn: _Conn, msg: dict) -> None:
        from repro_torch.core.instructions import ExecutionPlan
        from repro_torch.data.dataset import materialize_micro_batch

        it = int(msg["iter"])
        plan = ExecutionPlan.from_json(msg["plan"])
        t0 = time.perf_counter()
        to_bytes_s = 0.0
        if plan.micro_batches:
            gb = self.stream.batch(it)     # zero state transfer: pure in k
            batches = {m.mb_id: materialize_micro_batch(
                           m, gb.tokens, lengths=gb.lengths)
                       for m in plan.micro_batches}
            res = self.backend.execute_plan(
                plan, params=self.params, batches=batches,
                collect_timings=bool(msg.get("collect_timings")))
            t1 = time.perf_counter()
            blob = (_tree_to_bytes(res.grads)
                    if res.grads is not None else b"")
            to_bytes_s = time.perf_counter() - t1
            loss_sum, w_sum, timings = res.loss_sum, res.weight_sum, \
                res.timings
            del res
        else:
            blob, loss_sum, w_sum, timings = b"", 0.0, 0.0, []
        self._write_stats()
        conn.send({"type": "result", "rank": self.rank,
                   "epoch": msg["epoch"], "iter": it,
                   "loss_sum": float(loss_sum),
                   "weight_sum": float(w_sum),
                   "iter_time": time.perf_counter() - t0,
                   "to_bytes_s": to_bytes_s,
                   "timings": [list(t) for t in timings],
                   "t_sent": time.time()}, blob)

    def _do_step(self, conn: _Conn, msg: dict, blob) -> None:
        from repro_torch.train import checkpoint as CKPT
        from repro_torch.train.optimizer import adamw_update
        from repro_torch.train.runner import scale_

        t_got = time.time()
        t0 = time.perf_counter()
        grads = _tree_from_bytes(blob, self.device)
        h2d_s = time.perf_counter() - t0
        del blob
        scale_(grads, float(msg["scale"]))
        self.params, self.opt, om = adamw_update(
            self.params, grads, self.opt, self.opt_cfg)
        del grads
        grad_norm = float(om["grad_norm"])
        t0 = time.perf_counter()
        if msg.get("save"):
            CKPT.save(self.ckpt_dir, int(msg["iter"]) + 1,
                      {"params": self.params, "opt": self.opt})
        conn.send({"type": "step_ok", "rank": self.rank,
                   "epoch": msg["epoch"], "iter": msg["iter"],
                   "grad_norm": grad_norm, "t_got": t_got, "h2d_s": h2d_s,
                   "save_s": time.perf_counter() - t0})

    def _do_restore(self, conn: _Conn, msg: dict) -> None:
        from repro_torch.train import checkpoint as CKPT

        resume = None
        try:
            state, manifest = CKPT.load_latest_valid(
                self.ckpt_dir, {"params": self.params, "opt": self.opt})
            self.params, self.opt = state["params"], state["opt"]
            resume = int(manifest["step"])
        except FileNotFoundError:
            pass
        if resume is None:
            # nothing restorable: everyone re-inits from the seed and the
            # deterministic stream replays from 0 — consistent by
            # construction. Outside the handler, whose traceback still
            # holds the old state: one state on the card at a time
            self.params = self.opt = None
            self.params, self.opt = self._fresh_state()
            resume = 0
        conn.send({"type": "restore_ok", "rank": self.rank,
                   "epoch": msg["epoch"], "iter": -1, "resume": resume})


def _worker_entry(rundir: str, rank: int, payload: dict) -> None:
    """Spawn target (top-level for pickling). Worker stdout/stderr go to
    ``worker-{rank}.log`` so a hung or crashed replica is diagnosable from
    the launcher."""
    log = open(Path(rundir) / f"worker-{rank}.log", "a", buffering=1)
    sys.stdout = sys.stderr = log
    print(f"worker {rank} booting pid={os.getpid()}", flush=True)
    try:
        _Worker(Path(rundir), rank, payload).run()
        print(f"worker {rank} clean exit", flush=True)
    except BaseException as e:    # noqa: BLE001 — last-resort diagnostics
        print(f"worker {rank} crashed: {e!r}\n{traceback.format_exc()}",
              flush=True)
        raise


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _progress_iteration(rundir: Path) -> int:
    hist = _read_jsonl(rundir / HISTORY_FILE)
    return (max(h["iter"] for h in hist) + 1) if hist else 0


def _target_pid(rundir: Path, ev) -> Optional[int]:
    if ev.target == "coordinator":
        info = _read_json(rundir / COORD_FILE)
        return int(info["pid"]) if info else None
    info = _read_json(rundir / f"worker-{ev.replica}.json")
    return int(info["pid"]) if info else None


def _state_like(ckpt_dir: Path):
    """Host tensors shaped as the newest readable manifest's leaves, to
    load a checkpoint into without building the model: a 0-d ``int32``
    leaf is the format's ``int`` (the optimizer's step)."""
    from repro_torch.train import checkpoint as CKPT

    for step in reversed(CKPT.all_steps(ckpt_dir)):
        manifest = _read_json(ckpt_dir / f"step_{step:08d}" / "manifest.json")
        if manifest is None:
            continue
        return unflatten([
            (tuple(key.split("/")),
             0 if (info["dtype"], info["shape"]) == ("int32", [])
             else torch.empty(info["shape"], dtype=getattr(torch,
                                                            info["dtype"])))
            for key, info in manifest["leaves"].items()])
    return None


def _sum_launches(rundir: Path, n: int) -> tuple[dict, dict]:
    """The workers' launch counts summed, and each rank's stats file."""
    total: dict = {}
    per = {}
    for r in range(n):
        info = _read_json(rundir / f"stats-{r}.json")
        if info is None:
            continue
        per[r] = info
        for k, v in info["launches"].items():
            total[k] = total.get(k, 0) + int(v)
    return total, per


def run_process_cluster(cfg, cost, pcfg, rcfg, stream, opt_cfg=None,
                        chaos: Optional[FaultSchedule] = None,
                        ccfg: Optional[ClusterConfig] = None):
    """Drive one full training run in the process fault domain.

    Returns ``(params, history, stats)`` shaped like
    ``PlanAheadRunner.run()``. ``history`` keeps every logged occurrence
    (recovery replays re-log an iteration; last occurrence wins), each line
    also with its wall time ``t`` and the gradients' ``wire`` timings.
    ``params`` are restored from the final shared checkpoint and placed on
    ``rcfg.device``. ``stats.cluster`` carries the process-domain
    evidence: delivered kills with verified-dead pids, election/membership
    events, the orphan count after teardown, and the workers' kernel
    launches (summed, and per rank with each one's peak device memory).

    As the reference's cluster, the run ends at the absolute iteration
    ``rcfg.n_iters`` from whatever step the checkpoint directory restores;
    the in-process runner instead runs ``n_iters`` more from its restored
    step.
    """
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.runner import RunnerStats

    if opt_cfg is None:
        opt_cfg = AdamWConfig(lr=3e-4)
    ccfg = ccfg if ccfg is not None else ClusterConfig(
        n_replicas=max(1, pcfg.dp_size))
    rundir = Path(ccfg.rundir) if ccfg.rundir else \
        Path(tempfile.mkdtemp(prefix="repro-cluster-"))
    rundir.mkdir(parents=True, exist_ok=True)
    # workers run the threads plane; never recurse into the process domain
    rcfg_w = dataclasses.replace(
        rcfg, fault_domain="thread",
        ckpt_dir=rcfg.ckpt_dir or str(rundir / "ckpt"))
    pcfg_w = dataclasses.replace(pcfg, dp_size=ccfg.n_replicas)
    payload = {"cfg": cfg, "cost": cost, "pcfg": pcfg_w, "rcfg": rcfg_w,
               "opt_cfg": opt_cfg, "stream": stream, "ccfg": ccfg}

    ctx = multiprocessing.get_context("spawn")
    procs = {r: ctx.Process(target=_worker_entry,
                            args=(str(rundir), r, payload),
                            name=f"repro-worker-{r}")
             for r in range(ccfg.n_replicas)}
    for p in procs.values():
        p.start()

    kills: list[dict] = []
    result = None
    deadline = time.monotonic() + ccfg.run_timeout_s
    try:
        while time.monotonic() < deadline:
            result = _read_json(rundir / RESULT_FILE)
            if result is not None:
                break
            if chaos is not None:
                cur = _progress_iteration(rundir)
                for ev in chaos.take_process_kills(cur):
                    pid = _target_pid(rundir, ev)
                    rec = {"fault": ev.describe(), "target": ev.target,
                           "pid": pid, "at_iteration": cur,
                           "verified_dead": False, "t": time.time()}
                    if pid is not None:
                        # reap promptly: an unreaped SIGKILL corpse is a
                        # zombie, and zombies still answer signal-0 — the
                        # survivors' election waits on the probe flipping.
                        # For our own mp children the reap MUST go through
                        # Process.join (a raw waitpid would steal the wait
                        # status and leave is_alive() True forever)
                        proc = next((p for p in procs.values()
                                     if p.pid == pid), None)
                        if proc is not None:
                            with contextlib.suppress(ProcessLookupError):
                                os.kill(pid, signal.SIGKILL)
                            proc.join(10)
                            rec["verified_dead"] = bool(
                                not proc.is_alive() and not _pid_alive(pid))
                        else:
                            rec["verified_dead"] = deliver_kill(pid)
                    kills.append(rec)
            if not any(p.is_alive() for p in procs.values()):
                result = _read_json(rundir / RESULT_FILE)
                if result is not None:
                    break
                raise RuntimeError(
                    "all cluster processes died without a result; logs:\n"
                    + _tail_logs(rundir, ccfg.n_replicas))
            time.sleep(0.05)
        else:
            raise TimeoutError(
                f"cluster run exceeded {ccfg.run_timeout_s}s; logs:\n"
                + _tail_logs(rundir, ccfg.n_replicas))
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
        for p in procs.values():
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)

    orphans = [p.name for p in procs.values() if p.is_alive()]
    hist_by_iter: dict[int, dict] = {}
    history = []
    for h in _read_jsonl(rundir / HISTORY_FILE):
        history.append(h)
        hist_by_iter[h["iter"]] = h
    events = _read_jsonl(rundir / EVENTS_FILE)

    params = None
    like = _state_like(Path(rcfg_w.ckpt_dir))
    if like is not None:
        try:
            state, _ = CKPT.load_latest_valid(rcfg_w.ckpt_dir, like)
            params = tree_map(lambda x: x.to(rcfg.device), state["params"])
        except FileNotFoundError:
            pass    # run died before its first save; history tells why
        del like

    launches, workers = _sum_launches(rundir, ccfg.n_replicas)
    stats = RunnerStats(mode="process")
    stats.iters = len(hist_by_iter)
    stats.exec_s = sum(h["time_s"] for h in hist_by_iter.values())
    stats.real_tokens = sum(h["tokens"] for h in hist_by_iter.values())
    stats.padded_tokens = sum(h["padded_tokens"]
                              for h in hist_by_iter.values())
    stats.faults = len(kills) + sum(
        1 for e in events if e.get("kind") == "replica_lost")
    stats.recoveries = [e for e in events
                        if e.get("kind") in ("membership", "replica_lost",
                                             "election", "restore")]
    stats.cluster = {
        "completed": bool(result and result.get("completed")),
        "n_replicas": ccfg.n_replicas,
        "final_epoch": int(result["epoch"]) if result else -1,
        "final_alive": list(result.get("final_alive", [])) if result else [],
        # epoch 0 is the bootstrap claim, not a failover
        "elections": sum(1 for e in events
                         if e.get("kind") == "election"
                         and e.get("epoch", 0) > 0),
        "kills": kills,
        "orphans": orphans,
        "tmp_dirs_left": sorted(
            p.name for p in Path(rcfg_w.ckpt_dir).glob(".tmp-*")),
        "rundir": str(rundir),
        "launches": launches,
        "workers": workers,
    }
    return params, history, stats


def _tail_logs(rundir: Path, n: int, lines: int = 15) -> str:
    out = []
    for r in range(n):
        p = rundir / f"worker-{r}.log"
        try:
            tail = p.read_text().splitlines()[-lines:]
        except OSError:
            tail = ["<no log>"]
        out.append(f"--- worker {r} ---\n" + "\n".join(tail))
    return "\n".join(out)

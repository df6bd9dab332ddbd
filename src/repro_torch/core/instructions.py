"""Pipeline instruction set + serializable execution plans (paper §3).

Instruction kinds mirror DynaPipe/DeepSpeed: compute ops (FORWARD, BACKWARD)
and conjugate communication pairs — a *Start* op that launches an async
send/recv on the communication stream, and a *Wait* op that fences the
compute stream on it. The executor (core/executor.py) interprets these; the
planner (core/planner.py) emits them.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Optional


class Op(str, Enum):
    FORWARD = "F"
    BACKWARD = "B"
    SEND_ACT_START = "SA+"
    RECV_ACT_START = "RA+"
    WAIT_RECV_ACT = "RA!"
    SEND_GRAD_START = "SG+"
    RECV_GRAD_START = "RG+"
    WAIT_RECV_GRAD = "RG!"
    # optimizer step after the last backward of the iteration
    REDUCE_AND_STEP = "OPT"


class RecomputePolicy(str, Enum):
    NONE = "none"
    SELECTIVE = "selective"
    FULL = "full"


# comm-op groups shared by the renderer, the executor and repro_torch.analysis
SEND_OPS = (Op.SEND_ACT_START, Op.SEND_GRAD_START)
RECV_OPS = (Op.RECV_ACT_START, Op.RECV_GRAD_START)
WAIT_OPS = (Op.WAIT_RECV_ACT, Op.WAIT_RECV_GRAD)
COMM_START_OPS = SEND_OPS + RECV_OPS


@dataclass(frozen=True)
class Instr:
    op: Op
    micro_batch: int = -1
    peer: int = -1                     # peer stage for comm ops
    shape: Optional[tuple] = None      # communicated tensor shape (B, S, D)

    def short(self) -> str:
        """Unambiguous one-token rendering: ``SA+3->1`` (send to stage 1),
        ``RA!3<-0`` (wait on a recv from stage 0), ``OPT``. Direction arrows
        are uniform across Start and Wait ops so verifier counterexamples
        and ``PipelineError`` diagnostics read the same way; a missing peer
        renders as ``?`` instead of silently dropping the suffix."""
        s = self.op.value
        if self.micro_batch >= 0:
            s += str(self.micro_batch)
        if self.op in SEND_OPS:
            return f"{s}->{self.peer if self.peer >= 0 else '?'}"
        if self.op in RECV_OPS or self.op in WAIT_OPS:
            return f"{s}<-{self.peer if self.peer >= 0 else '?'}"
        return s


@dataclass
class MicroBatchSpec:
    """What the executor materializes for one micro-batch."""
    mb_id: int
    sample_indices: list[int]
    mbs: int                            # padded rows
    seq: Any                            # padded length (int or (enc, dec))
    t_fwd: float
    t_bwd: float
    mem: float


def _jsonable(obj: Any) -> Any:
    """Normalize a metadata tree to plain JSON types. Applied on *both*
    serialization directions so one round trip is a fixed point: numpy
    scalars become Python numbers (instead of being stringified by a
    ``default=`` hook), arrays and tuples become lists, and mapping keys
    become strings (what ``json.dumps`` would silently do anyway)."""
    if hasattr(obj, "tolist"):          # numpy array
        return obj.tolist()
    if hasattr(obj, "item"):            # numpy scalar
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    return str(obj)


@dataclass
class ExecutionPlan:
    n_stages: int
    micro_batches: list[MicroBatchSpec]
    per_stage: list[list[Instr]]        # instruction stream per stage
    recompute: RecomputePolicy = RecomputePolicy.FULL
    predicted_makespan: float = 0.0
    predicted_peak_mem: list[float] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    # ---------------- serialization (instruction store) ----------------
    def to_json(self) -> str:
        d = {
            "n_stages": int(self.n_stages),
            "recompute": self.recompute.value,
            "predicted_makespan": float(self.predicted_makespan),
            "predicted_peak_mem": _jsonable(self.predicted_peak_mem),
            "meta": _jsonable(self.meta),
            "micro_batches": [_jsonable(asdict(m))
                              for m in self.micro_batches],
            "per_stage": [
                [
                    {"op": i.op.value, "mb": _jsonable(i.micro_batch),
                     "peer": _jsonable(i.peer), "shape": _jsonable(i.shape)}
                    for i in stream
                ]
                for stream in self.per_stage
            ],
        }
        # everything above went through _jsonable — no default= escape
        # hatch, so a non-serializable plan fails loudly at plan time
        # instead of producing a lossy round trip
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        d = json.loads(s)
        for m in d["micro_batches"]:
            # JSON has no tuples: restore the 2D (enc, dec) seq convention
            if isinstance(m.get("seq"), list):
                m["seq"] = tuple(m["seq"])
        # normalize meta on the way in as well, so plans built in memory
        # (possibly with numpy-typed meta) and plans restored from JSON
        # compare equal after one round trip
        meta = _jsonable(d["meta"])
        if "injection_order" in meta:
            meta["injection_order"] = [
                int(x) for x in meta["injection_order"]]
        return cls(
            n_stages=d["n_stages"],
            micro_batches=[MicroBatchSpec(**m) for m in d["micro_batches"]],
            per_stage=[
                [
                    Instr(Op(i["op"]), i["mb"], i["peer"],
                          tuple(i["shape"]) if i["shape"] else None)
                    for i in stream
                ]
                for stream in d["per_stage"]
            ],
            recompute=RecomputePolicy(d["recompute"]),
            predicted_makespan=d["predicted_makespan"],
            predicted_peak_mem=d["predicted_peak_mem"],
            meta=meta,
        )


class InstructionStore:
    """In-memory stand-in for the paper's Redis instruction store: planners
    push serialized plans keyed by iteration, executors fetch (and block on)
    them. Thread-safe."""

    def __init__(self):
        import threading
        self._plans: dict[int, str] = {}
        self._cv = threading.Condition()

    def push(self, iteration: int, plan: ExecutionPlan) -> None:
        with self._cv:
            self._plans[iteration] = plan.to_json()
            self._cv.notify_all()

    def fetch(self, iteration: int, timeout: float = 60.0) -> ExecutionPlan:
        with self._cv:
            ok = self._cv.wait_for(lambda: iteration in self._plans, timeout)
            if not ok:
                raise TimeoutError(f"plan for iteration {iteration} not produced")
            return ExecutionPlan.from_json(self._plans[iteration])

    def evict_below(self, iteration: int) -> None:
        """Drop plans for iterations < ``iteration`` — executed plans are
        dead, and a long training run must not accumulate their JSON."""
        with self._cv:
            for it in [i for i in self._plans if i < iteration]:
                del self._plans[it]

    def clear(self) -> None:
        """Drop every stored plan — the recovery drain: plans produced under
        a dead topology or stale speed factors must not be executed."""
        with self._cv:
            self._plans.clear()
            self._cv.notify_all()

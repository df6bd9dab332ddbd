"""Static activation-liveness analysis over ExecutionPlan streams.

Replays the planner's memory accounting (core/planner.py charges
``spec.mem / n_stages`` per stage, core/simulator.py allocates it at the
micro-batch's FORWARD and frees it at its BACKWARD) directly over the
instruction streams. Because a stage's live set changes only at its own
F/B ops and those execute serially in stream order, the static walk is
timing-independent: it computes the exact peak the simulator predicted,
without running the simulator. Disagreement with
``plan.predicted_peak_mem`` therefore means the plan and its prediction
drifted apart (stale plan edit, mutated stream, wrong spec) — reported
as WARNING; exceeding an explicit memory limit is an ERROR.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.instructions import ExecutionPlan, Op

from repro_torch.analysis.report import Finding, Severity

# floats come out bit-identical when charge order matches the simulator;
# the tolerance only forgives benign summation-order noise
_REL_TOL = 1e-9


def analyze_memory(
    plan: ExecutionPlan,
    mem_limit: Optional[float] = None,
) -> tuple[list[Finding], list[float]]:
    """Returns (findings, per-stage peak memory)."""
    out: list[Finding] = []
    n = max(plan.n_stages, 1)
    charge = {m.mb_id: float(m.mem) / n for m in plan.micro_batches}
    peaks: list[float] = []

    for j, stream in enumerate(plan.per_stage):
        live = 0.0
        peak = 0.0
        went_negative = False
        for idx, ins in enumerate(stream):
            if ins.micro_batch not in charge:
                continue    # lint flags unknown-micro-batch
            if ins.op is Op.FORWARD:
                live += charge[ins.micro_batch]
                peak = max(peak, live)
            elif ins.op is Op.BACKWARD:
                live -= charge[ins.micro_batch]
                if live < -1e-12 * max(peak, 1.0) and not went_negative:
                    went_negative = True
                    out.append(Finding(
                        "negative-live-memory", Severity.ERROR,
                        f"stage {j}: live activation memory goes negative "
                        f"at B{ins.micro_batch} — a buffer is freed that "
                        "was never allocated", stage=j, index=idx,
                        micro_batch=ins.micro_batch))
        if live > 1e-12 * max(peak, 1.0):
            out.append(Finding(
                "activations-leaked", Severity.WARNING,
                f"stage {j}: {live:.3g} of activation memory is still "
                "live at stream end (forwards without backwards)",
                stage=j))
        peaks.append(peak)

    predicted = list(plan.predicted_peak_mem or [])
    if predicted and len(predicted) == len(peaks):
        for j, (got, want) in enumerate(zip(peaks, predicted)):
            tol = _REL_TOL * max(abs(want), abs(got), 1.0)
            if abs(got - want) > tol:
                out.append(Finding(
                    "peak-mem-mismatch", Severity.WARNING,
                    f"stage {j}: stream-derived peak {got:.6g} != "
                    f"predicted_peak_mem {want:.6g} — the plan and its "
                    "memory prediction drifted apart", stage=j))
    elif predicted:
        out.append(Finding(
            "peak-mem-mismatch", Severity.WARNING,
            f"predicted_peak_mem has {len(predicted)} entries for "
            f"{len(peaks)} stages"))

    if mem_limit is not None:
        for j, got in enumerate(peaks):
            if got > mem_limit * (1 + _REL_TOL):
                out.append(Finding(
                    "mem-limit-exceeded", Severity.ERROR,
                    f"stage {j}: static peak memory {got:.6g} exceeds "
                    f"the planner memory limit {mem_limit:.6g}", stage=j))
    return out, peaks

"""Static plan verification (docs/architecture.md §11).

DynaPipe re-plans every iteration, so pipeline correctness cannot be
audited once by hand the way a static 1F1B schedule can — it has to be
machine-checked per plan. This package proves three properties of an
:class:`~repro_torch.core.instructions.ExecutionPlan` without executing it:

- **deadlock-freedom** — a happens-before graph over the instruction
  streams (hb_graph.py) modelling the executor's compute/comm threads
  and in-order rendezvous channels; a cycle is a circular wait and is
  reported with a minimal counterexample.
- **IR well-formedness** — lint.py: unmatched Starts/Waits, F/B order,
  double-sends, shape and palette conformance, §6 pair-order
  consistency, injection-order metadata (rule table in the docs).
- **memory safety** — memory.py: stream-derived per-stage peak
  activation memory, checked against ``predicted_peak_mem`` and the
  planner's memory limit.

Entry points: :func:`verify_plan` (library), ``python -m repro_torch.analysis``
(CLI), ``PlannerConfig(verify_plans=True)`` (planner-pool workers verify
off the critical path), and ``strict=True`` on the executor/backends
(refuse ERROR-level plans).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.instructions import ExecutionPlan
from repro_torch.core.shapes import ShapePalette

from repro_torch.analysis.hb_graph import HBGraph, build_hb_graph
from repro_torch.analysis.lint import lint_plan
from repro_torch.analysis.memory import analyze_memory
from repro_torch.analysis.report import (
    Finding,
    PlanVerificationError,
    Severity,
    VerifyReport,
)

__all__ = [
    "Finding", "HBGraph", "PlanVerificationError", "Severity",
    "VerifyReport", "analyze_memory", "build_hb_graph", "lint_plan",
    "verify_plan", "assert_plan_clean",
]


def verify_plan(
    plan: ExecutionPlan,
    *,
    palette: Optional[ShapePalette] = None,
    mem_limit: Optional[float] = None,
    check_hb: bool = True,
) -> VerifyReport:
    """Run every static pass over one plan and aggregate the findings."""
    report = VerifyReport(meta={
        "n_stages": plan.n_stages,
        "n_micro_batches": len(plan.micro_batches),
        "n_instructions": sum(len(s) for s in plan.per_stage),
    })
    report.extend(lint_plan(plan, palette=palette))

    mem_findings, peaks = analyze_memory(plan, mem_limit=mem_limit)
    report.extend(mem_findings)
    report.meta["peak_mem"] = peaks

    if check_hb and len(plan.per_stage) == plan.n_stages:
        g = build_hb_graph(plan)
        report.meta["hb_nodes"] = len(g.edges)
        report.meta["hb_edges"] = g.n_edges()
        cycle = g.find_cycle()
        if cycle is not None:
            lines = g.describe_cycle(cycle)
            report.meta["hb_cycle"] = lines
            stage, idx, _ = cycle[0]
            report.add(
                "hb-cycle", Severity.ERROR,
                "happens-before cycle (circular wait -> deadlock):\n"
                + "\n".join(f"    {ln}" for ln in lines),
                stage=stage, index=idx,
                micro_batch=g.instr(cycle[0]).micro_batch)
    return report


def assert_plan_clean(plan: ExecutionPlan, **kwargs) -> VerifyReport:
    """``verify_plan`` that raises :class:`PlanVerificationError` on any
    ERROR-level finding (the strict-mode helper)."""
    report = verify_plan(plan, **kwargs)
    if report.errors:
        raise PlanVerificationError(
            f"plan rejected: {len(report.errors)} ERROR-level finding(s)",
            report)
    return report

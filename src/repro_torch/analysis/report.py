"""Severity-leveled findings shared by every verifier pass.

Every pass (hb_graph, lint, memory) emits ``Finding`` records into a
``VerifyReport``; callers decide what a finding means for them: the CLI
maps the worst severity to an exit code, the planner's opt-in
``verify_plans`` raises ``PlanVerificationError`` on ERROR, and strict
executors/backends refuse ERROR-level plans before touching a channel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional


class Severity(IntEnum):
    INFO = 10       # observation, never actionable on its own
    WARNING = 20    # suspicious but not provably wrong (e.g. peak-mem drift)
    ERROR = 30      # plan is defective: deadlock, crash, or wrong result

    @property
    def label(self) -> str:
        return self.name


@dataclass(frozen=True)
class Finding:
    rule: str                           # stable kebab-case rule id
    severity: Severity
    message: str
    stage: Optional[int] = None         # stream the finding anchors to
    index: Optional[int] = None         # instruction index in that stream
    micro_batch: Optional[int] = None

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity.label,
            "message": self.message,
            "stage": self.stage,
            "index": self.index,
            "micro_batch": self.micro_batch,
        }

    def __str__(self) -> str:
        where = ""
        if self.stage is not None:
            where = f" [stage {self.stage}"
            if self.index is not None:
                where += f" #{self.index}"
            where += "]"
        return f"{self.severity.label} {self.rule}{where}: {self.message}"


@dataclass
class VerifyReport:
    """Aggregated findings for one ExecutionPlan."""
    findings: list[Finding] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def add(self, rule: str, severity: Severity, message: str, *,
            stage: Optional[int] = None, index: Optional[int] = None,
            micro_batch: Optional[int] = None) -> None:
        self.findings.append(Finding(rule, severity, message, stage=stage,
                                     index=index, micro_batch=micro_batch))

    def extend(self, findings: list[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity >= Severity.ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    def worst(self) -> Optional[Severity]:
        if not self.findings:
            return None
        return max(f.severity for f in self.findings)

    def ok(self, level: Severity = Severity.ERROR) -> bool:
        """True if no finding is at or above ``level``."""
        return all(f.severity < level for f in self.findings)

    def to_dict(self) -> dict:
        worst = self.worst()
        return {
            "ok": self.ok(),
            "worst": worst.label if worst is not None else None,
            "counts": {
                sev.label: sum(1 for f in self.findings
                               if f.severity == sev)
                for sev in Severity
            },
            "findings": [f.to_dict() for f in self.findings],
            "meta": self.meta,
        }

    def summary(self) -> str:
        worst = self.worst()
        head = (f"{len(self.findings)} finding(s), "
                f"worst={worst.label if worst else 'none'}")
        body = "\n".join(f"  {f}" for f in self.findings)
        return head if not body else f"{head}\n{body}"


class PlanVerificationError(RuntimeError):
    """Raised when a plan with ERROR-level findings reaches a caller that
    opted into verification (``PlannerConfig.verify_plans`` or a strict
    executor/backend)."""

    def __init__(self, message: str, report: VerifyReport):
        super().__init__(f"{message}\n{report.summary()}")
        self.report = report

"""Dynamic recomputation (paper §7): per-iteration choice of activation-
checkpoint policy by re-running planning under each policy's cost model and
keeping the fastest plan that fits device memory."""
from __future__ import annotations

from typing import Callable

from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.instructions import RecomputePolicy

# extra backward compute multiplier per policy (recompute cost) and the
# activation-memory class used by AnalyticCostModel
BWD_OVERHEAD = {
    RecomputePolicy.NONE: 1.0,
    RecomputePolicy.SELECTIVE: 1.12,
    RecomputePolicy.FULL: 1.33,
}


def cost_model_for(cfg, n_stages: int, policy: RecomputePolicy,
                   hw=None) -> AnalyticCostModel:
    """Cost model whose backward time carries the policy's recompute tax.

    The multiplier is a plain ``bwd_mult`` field on :class:`AnalyticCostModel`
    (not a closure-captured subclass), so the model stays picklable for
    process-pool planning and its batched ``stage_times_batch`` path sees the
    same scaled backward times as the scalar API.
    """
    kw = {"hw": hw} if hw is not None else {}
    return AnalyticCostModel(cfg, n_stages, remat=policy.value,
                             bwd_mult=BWD_OVERHEAD[policy], **kw)


def choose_recompute(plan_under_policy: Callable, device_mem: float):
    """plan_under_policy(policy) -> plan with .predicted_makespan and
    .predicted_peak_mem. Returns the fastest plan that fits; falls back to
    FULL if nothing fits (FULL minimizes memory)."""
    best = None
    for policy in (RecomputePolicy.NONE, RecomputePolicy.SELECTIVE,
                   RecomputePolicy.FULL):
        try:
            plan = plan_under_policy(policy)
        except (ValueError, RuntimeError):
            continue
        fits = max(plan.predicted_peak_mem, default=0.0) <= device_mem
        if fits and (best is None or plan.predicted_makespan < best.predicted_makespan):
            best = plan
    if best is None:
        best = plan_under_policy(RecomputePolicy.FULL)
    return best

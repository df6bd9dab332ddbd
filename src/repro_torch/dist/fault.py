"""Fault tolerance: straggler detection + elastic re-planning (DESIGN §5).

DynaPipe's planner is stateless per iteration, which makes the fault story
cheap: when the replica set or relative replica speeds change, we simply
re-run ``core/planner.plan_iteration`` over the *surviving* replicas with
per-replica speed factors — ``balance_replicas`` then hands a slow replica
proportionally less work and a dead one none.

Two pieces:

- :class:`StragglerMonitor` — heartbeat registry. Each replica reports
  ``heartbeat(replica, iter_time=...)`` once per iteration; the monitor
  derives liveness (no heartbeat within ``heartbeat_timeout``) and
  normalized speed factors (fastest replica = 1.0) from a sliding window of
  iteration times. ``clock`` is injectable for tests.
- :class:`ElasticPlanManager` — wraps the monitor plus a ``replan``
  callable. Each :meth:`~ElasticPlanManager.plan` sweep recomputes the
  alive set, reports deaths/recoveries since the previous sweep, and calls
  ``replan(lengths, dp_size, speed_factors)`` over the survivors.

Wire-up: the training loop heartbeats its monitor each iteration and feeds
``speed_factors()`` into the next ``PlannerConfig``; a control process uses
``ElasticPlanManager`` with :func:`make_planner_replan` when replicas can
actually come and go.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence


class StragglerMonitor:
    """Heartbeat + iteration-time registry for ``n_replicas`` DP replicas."""

    def __init__(self, n_replicas: int, heartbeat_timeout: float = 30.0,
                 window: int = 8, clock: Callable[[], float] = time.monotonic):
        self.n_replicas = n_replicas
        self.heartbeat_timeout = heartbeat_timeout
        self.clock = clock
        # construction counts as a heartbeat: a replica that has not yet
        # reported gets one full timeout of grace instead of being declared
        # dead at t=0 while still warming up
        now = self.clock()
        self._last_seen: list[float] = [now] * n_replicas
        self._iter_times = [deque(maxlen=window) for _ in range(n_replicas)]

    def heartbeat(self, replica: int, iter_time: Optional[float] = None):
        """Record that ``replica`` is alive (optionally with its last
        iteration's wall time)."""
        self._last_seen[replica] = self.clock()
        if iter_time is not None:
            self._iter_times[replica].append(float(iter_time))

    def alive(self) -> list[int]:
        """Replicas that have heartbeat within the timeout, ascending."""
        now = self.clock()
        return [r for r in range(self.n_replicas)
                if now - self._last_seen[r] <= self.heartbeat_timeout]

    def mean_iter_time(self, replica: int) -> Optional[float]:
        times = self._iter_times[replica]
        return sum(times) / len(times) if times else None

    def speed_factors(self) -> list[float]:
        """Per-replica relative speed, fastest = 1.0 (a replica at factor
        0.5 takes twice as long per iteration and should get half the
        work). Replicas with no timing samples default to 1.0."""
        means = [self.mean_iter_time(r) for r in range(self.n_replicas)]
        known = [m for m in means if m]
        if not known:
            return [1.0] * self.n_replicas
        fastest = min(known)
        return [fastest / m if m else 1.0 for m in means]

    def drift(self) -> float:
        """Slowest/fastest mean-iteration-time ratio (1.0 = perfectly even).
        Callers replan when this exceeds their tolerance."""
        means = [m for m in (self.mean_iter_time(r)
                             for r in range(self.n_replicas)) if m]
        return max(means) / min(means) if means else 1.0


class ElasticPlanManager:
    """Re-plan micro-batch splits when the replica set or speeds change.

    ``replan(lengths, dp_size, speed_factors) -> plan`` is typically
    :func:`make_planner_replan`'s closure over ``core/planner``; tests pass
    a recording stub. ``speed_factors`` is indexed by *position in the
    alive list*, matching how ``balance_replicas`` consumes it.
    """

    def __init__(self, monitor: StragglerMonitor, replan: Callable):
        self.monitor = monitor
        self.replan = replan
        self._known_dead: set[int] = set()
        self._prev_alive: list[int] = list(range(monitor.n_replicas))

    def plan(self, lengths) -> dict:
        """One planning sweep. Returns::

            {"plan": <replan result or None if nothing is alive>,
             "alive": [...], "dead": [...],
             "dead_this_sweep": [...],       # newly-declared since last sweep
             "recovered_this_sweep": [...],  # back from the dead
             "replica_set_changed": bool,    # vs the previous sweep
             "speed_factors": [...]}         # aligned with "alive"
        """
        alive = self.monitor.alive()
        dead = [r for r in range(self.monitor.n_replicas) if r not in alive]
        dead_this_sweep = [r for r in dead if r not in self._known_dead]
        recovered = [r for r in alive if r in self._known_dead]
        changed = alive != self._prev_alive
        self._known_dead = set(dead)
        self._prev_alive = list(alive)

        all_factors = self.monitor.speed_factors()
        speed_factors = [all_factors[r] for r in alive]
        plan = (self.replan(lengths, len(alive), speed_factors)
                if alive else None)
        return {
            "plan": plan,
            "alive": alive,
            "dead": dead,
            "dead_this_sweep": dead_this_sweep,
            "recovered_this_sweep": recovered,
            "replica_set_changed": changed,
            "speed_factors": speed_factors,
        }


def make_planner_replan(cost, pcfg):
    """Bind ``core/planner.plan_iteration`` into an ``ElasticPlanManager``
    replan callable: each call re-plans over the current survivor count with
    their measured speed factors."""
    from repro_torch.core.planner import plan_iteration

    def replan(lengths, dp_size: int, speed_factors: Sequence[float]):
        p = dataclasses.replace(pcfg, dp_size=max(dp_size, 1),
                                speed_factors=list(speed_factors))
        return plan_iteration(lengths, cost, p)

    return replan

"""Event-driven pipeline simulator (makespan / memory / safety stocks).

Replays a per-device op order (from ``core.schedule``) against micro-batch
execution times, respecting pipeline dependencies:

  F(i, j) needs F(i, j-1) + comm     B(i, j) needs B(i, j+1) + comm
  B(i, c-1) needs F(i, c-1)

Devices execute their op list strictly in order (that is what an instruction
-driven executor does); an op starts at max(device free, dependency ready).
Used for: the paper's Fig. 7 noise-robustness experiment, Fig. 10/Eq. 1
validation, schedule search (cluster permutation), comm planning (§6 needs
the simulated timeline), and the memory-aware scheduling tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SimResult:
    makespan: float
    start: dict                 # (mb, stage, kind) -> start time
    end: dict                   # (mb, stage, kind) -> end time
    peak_mem: list[float]
    idle_frac: list[float]
    safety_stock_min: list[int]

    def timeline(self):
        """[(start, end, stage, mb, kind)] sorted by end time."""
        out = [(self.start[k], self.end[k], k[1], k[0], k[2]) for k in self.start]
        return sorted(out, key=lambda x: (x[1], x[0]))


def _as_table(x, n_micro, n_stages):
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 0:
        return np.full((n_micro, n_stages), float(a))
    if a.ndim == 1:
        return np.repeat(a[:, None], n_stages, axis=1)
    return a


def simulate(
    order: list[list[tuple[int, str]]],
    t_fwd,                       # scalar | (n_micro,) | (n_micro, n_stages)
    t_bwd=None,
    *,
    act_mem=None,
    comm_latency: float = 0.0,
    noise_std: float = 0.0,
    rng: np.random.Generator | None = None,
) -> SimResult:
    n_stages = len(order)
    n_micro = 1 + max((i for dev in order for i, _ in dev), default=-1)
    tf = _as_table(t_fwd, n_micro, n_stages)
    tb = _as_table(t_bwd if t_bwd is not None else 2.0 * tf, n_micro, n_stages)
    am = _as_table(act_mem if act_mem is not None else 0.0, n_micro, n_stages)
    if noise_std > 0.0:
        rng = rng or np.random.default_rng(0)
        tf = np.maximum(tf * (1 + rng.normal(0, noise_std, tf.shape)), 1e-9)
        tb = np.maximum(tb * (1 + rng.normal(0, noise_std, tb.shape)), 1e-9)

    end: dict = {}
    start: dict = {}
    ptr = [0] * n_stages
    dev_free = [0.0] * n_stages
    mem = [0.0] * n_stages
    peak = [0.0] * n_stages
    busy = [0.0] * n_stages
    stock_min = [10 ** 9] * n_stages

    def dep_ready(i, j, kind):
        if kind == "F":
            if j == 0:
                return 0.0
            key = (i, j - 1, "F")
            return end.get(key) if key in end else None
        if j == n_stages - 1:
            key = (i, j, "F")
            return end.get(key) if key in end else None
        key = (i, j + 1, "B")
        return end.get(key) if key in end else None

    total = sum(len(d) for d in order)
    scheduled = 0
    while scheduled < total:
        progress = False
        for j in range(n_stages):
            while ptr[j] < len(order[j]):
                i, kind = order[j][ptr[j]]
                r = dep_ready(i, j, kind)
                if r is None:
                    break
                # comm latency applies only to ops whose dependency arrives
                # over a link: stage-0 forward injections come from the host
                # (dep_ready == 0.0) and the last stage's backward consumes
                # its own forward locally — neither pays a hop.
                local = (kind == "F" and j == 0) or \
                        (kind == "B" and j == n_stages - 1)
                r = r + (0.0 if local else comm_latency)
                # safety stock at the moment the device frees up: how many of
                # the device's upcoming ops are already dependency-ready
                s = dev_free[j]
                t0 = max(s, r)
                dur = tf[i, j] if kind == "F" else tb[i, j]
                start[(i, j, kind)] = t0
                end[(i, j, kind)] = t0 + dur
                dev_free[j] = t0 + dur
                busy[j] += dur
                if kind == "F":
                    mem[j] += am[i, j]
                    peak[j] = max(peak[j], mem[j])
                else:
                    mem[j] -= am[i, j]
                ptr[j] += 1
                scheduled += 1
                progress = True
        if not progress:
            stuck = [(j, order[j][ptr[j]]) for j in range(n_stages)
                     if ptr[j] < len(order[j])]
            raise RuntimeError(f"simulation deadlock; waiting on {stuck[:4]}")

    makespan = max(end.values())
    idle = [1.0 - busy[j] / makespan if makespan > 0 else 0.0
            for j in range(n_stages)]

    # safety-stock analysis: at every op completion on device j, count how
    # many subsequent ops of j were already ready strictly before that time.
    events = sorted(((end[k], k) for k in end))
    ready_time: dict = {}
    for k, v in end.items():
        i, j, kind = k
        if kind == "F" and j + 1 < n_stages:
            ready_time[(i, j + 1, "F")] = v
        if kind == "F" and j == n_stages - 1:
            ready_time[(i, j, "B")] = v
        if kind == "B" and j > 0:
            ready_time[(i, j - 1, "B")] = v
    for i, _, _ in [(i, j, k) for (i, j, k) in end]:
        ready_time.setdefault((i, 0, "F"), 0.0)
    pos = {}
    for j in range(n_stages):
        for idx, (i, kind) in enumerate(order[j]):
            pos[(i, j, kind)] = idx
    for t, (i, j, kind) in events:
        idx = pos[(i, j, kind)]
        stock = 0
        for nxt in order[j][idx + 1:]:
            key = (nxt[0], j, nxt[1])
            if ready_time.get(key, float("inf")) <= t:
                stock += 1
            else:
                break
        stock_min[j] = min(stock_min[j], stock)
    stock_min = [0 if s == 10 ** 9 else s for s in stock_min]

    return SimResult(makespan, start, end, peak, idle, stock_min)

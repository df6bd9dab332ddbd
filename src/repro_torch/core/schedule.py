"""Pipeline execution schedules (paper §5).

Produces per-device ordered op lists ``[(mb, 'F'|'B'), ...]``:

- :func:`schedule_1f1b` — the standard 1F1B order (baseline; zero safety
  stock in steady state, fragile to execution-time variation).
- :func:`schedule_adaptive` — memory-aware adaptive cyclic scheduling
  (Alg. 1): per cycle each device tries one backward then one forward,
  forwards are delayed when the device's activation budget is exhausted,
  and micro-batch *injection* at stage 0 is what regulates safety stock.
- :func:`cluster_permute_order` — micro-batch injection ordering: cluster by
  predicted execution time, try all cluster permutations through the
  simulator, keep the best (paper finds 3-4 clusters suffice).
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np


def schedule_1f1b(n_micro: int, n_stages: int) -> list[list[tuple[int, str]]]:
    out = []
    for j in range(n_stages):
        warmup = min(n_stages - 1 - j, n_micro)
        order: list[tuple[int, str]] = [(i, "F") for i in range(warmup)]
        nf, nb = warmup, 0
        while nb < n_micro:
            if nf < n_micro:
                order.append((nf, "F"))
                nf += 1
            order.append((nb, "B"))
            nb += 1
        out.append(order)
    return out


def schedule_adaptive(
    n_micro: int,
    n_stages: int,
    act_mem,                       # act_mem[i][j] or (n_micro, n_stages) array
    mem_limit,                     # scalar or per-stage list
    injection_order: Sequence[int] | None = None,
) -> list[list[tuple[int, str]]]:
    """Memory-aware adaptive scheduling — Alg. 1 of the paper."""
    a = np.asarray(act_mem, dtype=np.float64)
    if a.ndim == 1:
        a = np.repeat(a[:, None], n_stages, axis=1)
    lim = np.broadcast_to(np.asarray(mem_limit, dtype=np.float64), (n_stages,))
    order = list(injection_order) if injection_order is not None else list(range(n_micro))
    assert sorted(order) == list(range(n_micro))

    O: list[list[tuple[int, str]]] = [[] for _ in range(n_stages)]
    Sf: list[list[int]] = [[] for _ in range(n_stages)]
    Sb: list[list[int]] = [[] for _ in range(n_stages)]
    Nf: list[list[int]] = [[] for _ in range(n_stages)]
    Nb: list[list[int]] = [[] for _ in range(n_stages)]
    mem = np.zeros(n_stages)
    Sf[0] = list(order)
    done_b = 0
    total_b = n_micro * n_stages

    while done_b < total_b:
        progress = False
        for j in range(n_stages):
            if Sb[j]:
                i = Sb[j].pop(0)
                mem[j] -= a[i, j]
                O[j].append((i, "B"))
                done_b += 1
                progress = True
                if j > 0:
                    Nb[j - 1].append(i)
            if Sf[j]:
                i = Sf[j][0]
                if mem[j] + a[i, j] <= lim[j]:
                    Sf[j].pop(0)
                    mem[j] += a[i, j]
                    O[j].append((i, "F"))
                    progress = True
                    if j + 1 < n_stages:
                        Nf[j + 1].append(i)
                    else:
                        Nb[j].append(i)      # last stage: backward next
        for j in range(n_stages):
            Sf[j].extend(Nf[j])
            Sb[j].extend(Nb[j])
            Nf[j], Nb[j] = [], []
        if not progress:
            raise RuntimeError(
                "adaptive schedule stalled: a single micro-batch exceeds the "
                f"stage memory limit (mem={mem}, lim={lim})")
    return O


def safety_stock_trace(order: list[list[tuple[int, str]]], n_stages: int):
    """Count of ready-but-unexecuted ops per device over schedule steps —
    used by the Fig. 11 style analyses/tests."""
    # replay the schedule as a dependency simulation, tracking buffer sizes
    from repro_torch.core.simulator import simulate
    return simulate(order, t_fwd=1.0, t_bwd=1.0).safety_stock_min


def cluster_permute_order(
    times: Sequence[float],
    n_clusters: int = 3,
    evaluate=None,
) -> list[int]:
    """Cluster micro-batches by predicted time; permute clusters; keep the
    order that minimizes ``evaluate(order) -> makespan``."""
    n = len(times)
    if n == 0:
        return []
    t = np.asarray(times)
    n_clusters = min(n_clusters, n)
    qs = np.quantile(t, np.linspace(0, 1, n_clusters + 1)[1:-1]) if n_clusters > 1 else []
    labels = np.searchsorted(qs, t)
    clusters = [list(np.where(labels == c)[0]) for c in range(n_clusters)]
    clusters = [c for c in clusters if c]
    unpermuted = [i for c in clusters for i in c]
    if evaluate is None or len(clusters) <= 1:
        return unpermuted
    # fall back to the unpermuted cluster order when evaluate never yields a
    # finite makespan (e.g. every permutation raises memory-infeasible) —
    # returning None would crash the scheduler downstream
    best, best_val = unpermuted, float("inf")
    for perm in itertools.permutations(range(len(clusters))):
        cand = [i for ci in perm for i in clusters[ci]]
        val = evaluate(cand)
        if np.isfinite(val) and val < best_val:
            best, best_val = cand, val
    return best

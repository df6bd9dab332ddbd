"""The profiler's trace of the traced sub-window, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

``KERNEL_SYMBOLS`` and ``KINDS`` are copied, frozen, from
``chip_smoke.py`` at commit 6c281531521ac131e36dd31e0d5322d0dc64508a: the
port's kernels by symbol, and every device kernel by kind, first match
wins. Device activity is every CUDA event of the trace (kernels, copies,
sets), user annotations left out; the device is busy where their union
is, and idle elsewhere in the window. An idle gap is labelled by what the host was doing at its middle:
the innermost of the harness's own spans (``portbench.*``) and, inside
it, the innermost operation the profiler recorded on that thread.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

KERNEL_SYMBOLS = {"K1": "mha_fwd_", "K2/K3": "mha_bwd_",
                  "K4": "ssd_fwd_kernel", "K4's backward": "ssd_bwd_"}
KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
         ("K1-K4", tuple(KERNEL_SYMBOLS.values())),
         ("elementwise", ("elementwise",)), ("reduce", ("reduce",)),
         ("copy", ("copy", "Cat")))
SPAN_PREFIX = "portbench."
# gaps labelled one by one, longest first; the rest are summed unlabelled
LABELLED_GAPS = 400


def kind_of(name: str) -> str:
    return next((k for k, pats in KINDS if any(p in name for p in pats)),
                "other")


@dataclass
class TraceSummary:
    wall_s: float                   # the traced sub-window, host clock
    busy_s: float                   # union of device activity
    kernel_s: float                 # sum of device activity
    by_kind: dict                   # kind -> seconds
    symbols: dict                   # KERNEL_SYMBOLS key -> (seconds, count)
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[label, seconds]]


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else 1000 * getattr(e, f"{what}_us")()


def summarize(prof, wall_s: float) -> TraceSummary:
    """``prof``: a stopped ``torch.profiler.profile`` with CPU and CUDA
    activity over a window of ``wall_s`` host seconds."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == cuda:
            # the harness's spans also appear on the device's timeline, as
            # user annotations that cover the work: they are no operation
            if not (e.name().startswith(SPAN_PREFIX)
                    or getattr(e, "is_user_annotation", bool)()):
                dev.append((start, end, e.name()))
        else:
            cpu.append((start, end, e.name(), e.start_thread_id()))
    by_name = defaultdict(float)
    for s, t, n in dev:
        by_name[n] += (t - s) * 1e-9
    kernel_s = sum(by_name.values())
    by_kind = defaultdict(float)
    for n, sec in by_name.items():
        by_kind[kind_of(n)] += sec
    symbols = {}
    for kid, sym in KERNEL_SYMBOLS.items():
        hit = [(t - s) * 1e-9 for s, t, n in dev if sym in n]
        if hit:
            symbols[kid] = (sum(hit), len(hit))
    iv = sorted((s, t) for s, t, _ in dev)
    merged = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_s = sum(t - s for s, t in merged) * 1e-9
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
             merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        wall_s=wall_s, busy_s=busy_s, kernel_s=kernel_s,
        by_kind=dict(by_kind), symbols=symbols,
        device_ops=[[n[:120], s] for n, s in top],
        idle_gaps=_label_gaps(gaps, cpu))


def _label_gaps(gaps, cpu) -> list:
    if not gaps:
        return []
    spans = [c for c in cpu if c[2].startswith(SPAN_PREFIX)]
    st = np.array([c[0] for c in cpu], dtype=np.int64)
    en = np.array([c[1] for c in cpu], dtype=np.int64)
    tid = np.array([c[3] for c in cpu], dtype=np.int64)
    sst = np.array([c[0] for c in spans], dtype=np.int64)
    sen = np.array([c[1] for c in spans], dtype=np.int64)
    totals = defaultdict(float)
    for length, a, b in gaps[:LABELLED_GAPS]:
        mid = (a + b) // 2
        label = "no harness span"
        inside = np.nonzero((sst <= mid) & (sen >= mid))[0]
        if len(inside):
            k = inside[np.argmin(sen[inside] - sst[inside])]
            label = spans[k][2][len(SPAN_PREFIX):]
            ops = np.nonzero((st <= mid) & (en >= mid)
                             & (tid == spans[k][3]))[0]
            ops = [i for i in ops if not cpu[i][2].startswith(SPAN_PREFIX)]
            if ops:
                i = min(ops, key=lambda i: en[i] - st[i])
                label += "/" + cpu[i][2][:80]
        totals[label] += length * 1e-9
    rest = sum(g[0] for g in gaps[LABELLED_GAPS:]) * 1e-9
    if rest > 0:
        totals["shorter gaps"] += rest
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:10]]

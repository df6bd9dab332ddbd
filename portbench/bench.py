"""The harness: one run of one cell, as ``run.py`` is invoked.

Set-up runs from the process's start to the window's: imports, the
kernels' libraries (built with nvcc into the checkout's
``build/repro_torch_kernels/`` on a checkout's first run, loaded after),
the weights, and a first pass over the traffic's pool of global batches
(a cycle), which warms up every shape the window will use and whose first
``CHECK_STEPS`` steps give the readings ``correct`` is decided by. The
window is then whole cycles, until ``--seconds`` have passed; with
``--trace 1`` one more cycle runs under ``torch.profiler``. After the
window the program's state is freed, the plain reference follows the
first steps from the same weights and batches, and the last line of
standard output is the result.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CHECK_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN = "portbench."


class Refusal(Exception):
    """A run that must print no result: no card, a missing file, a
    forbidden module."""


@dataclass
class Cell:
    name: str
    chips: int
    config: str
    traffic: str
    model: dict
    spec: dict
    limits: dict


@dataclass
class Run:
    """What a mode measured and read; the metric readers take it."""
    model: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    iters: int = 0
    cycle: int = 0                # iterations a cycle (a pass over the pool)
    real_tokens: int = 0
    positions: int = 0            # positions the steps computed
    model_flops: float = 0.0
    plan_wait_s: float | None = None
    peak_bytes: int = 0
    trace: object = None          # trace.TraceSummary of the traced cycle
    traced_mbs: list = field(default_factory=list)   # [[(enc, dec)]]
    program: dict = field(default_factory=dict)      # check.readings' input
    layout_errors: int = 0
    failed_iters: int = 0


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refusal(f"no workload {name!r} in BENCHMARK.json "
                      f"(known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(name=name, chips=int(w["chips"]), config=w["config"],
                traffic=w["traffic"],
                model=json.loads((ROOT / configs[w["config"]]["file"])
                                 .read_text())["model"],
                spec=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                                .read_text()),
                limits=json.loads((HERE / "limits" / f"{name}.json")
                                  .read_text()))


def metric_specs(cell: Cell, trace: bool) -> list:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell.name in m["workloads"]]


def read_metric(name: str, run: Run):
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Window:
    """Decides at the start of each iteration whether the run goes on.

    Iterations ``0 .. cycle - 1`` warm up. The window opens at the first
    cycle boundary after them and closes at the first cycle boundary at
    least ``seconds`` later; each boundary synchronises the device. With
    ``trace`` one more cycle runs under the profiler. ``on_open(it)`` and
    ``on_close(it)`` let the mode read its counters there. With
    ``check_only`` (``readings.py``) the run stops after the first
    ``CHECK_STEPS`` iterations and the window never opens."""

    def __init__(self, cycle, seconds, trace, device, on_open=None,
                 on_close=None, check_only=False):
        self.cycle, self.seconds, self.trace = cycle, seconds, trace
        self.check_only = check_only
        self.device = device
        self.on_open, self.on_close = on_open, on_close
        self.t_open = self.t_close = None
        self.it_open = self.it_close = None
        self.peak_bytes = 0
        self.prof = None
        self.summary = None

    def _now(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def at_iteration(self, it: int) -> bool:
        if self.check_only:
            return it < CHECK_STEPS
        if it < self.cycle or it % self.cycle:
            return True
        now = self._now()
        if self.t_open is None:
            import torch
            self.t_open, self.it_open = now, it
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            if self.on_open:
                self.on_open(it)
            return True
        if self.t_close is None:
            if now - self.t_open < self.seconds:
                return True
            import torch
            self.t_close, self.it_close = now, it
            if self.device.type == "cuda":
                self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            if self.on_close:
                self.on_close(it)
            if not self.trace:
                return False
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t_trace = self._now()
            return True
        wall = self._now() - self.t_trace
        self.prof.stop()
        from portbench import trace
        self.summary = trace.summarize(self.prof, wall)
        self.prof = None
        return False

    @property
    def traced(self):
        """Iterations of the traced cycle."""
        return (range(self.it_close, self.it_close + self.cycle)
                if self.trace else range(0))


def span(name: str):
    import torch
    return torch.profiler.record_function(SPAN + name)


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, mode=None) -> dict:
    """One run; returns the result line's object. ``mode`` replaces the
    traffic's mode module (tests plant faults through it)."""
    import torch

    from portbench import check, reference, weights
    from portbench.traffic import CellTraffic
    mode = mode or importlib.import_module(f"portbench.modes.{cell.spec['mode']}")
    run = mode.run(cell, seed, seconds, trace, device, t0)
    free_device(device)
    print(f"[portbench] setup {run.setup_s:.3f} s; window {run.window_s:.3f} s,"
          f" {run.iters} iterations, {run.real_tokens} real tokens of "
          f"{run.positions} positions, peak {run.peak_bytes} bytes",
          file=sys.stderr, flush=True)
    metrics = {}
    for m in metric_specs(cell, trace):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    traffic = CellTraffic(cell.spec, cell.model["vocab"], seed)
    ref = reference.train_steps(
        cell.model, weights.make_params(cell.model, seed, device),
        [traffic.batch(i) for i in range(CHECK_STEPS)], cell.spec["optimizer"],
        chunk_tokens=cell.model["reference_chunk_tokens"])
    numbers = check.readings(run.program, ref)
    numbers["layout"] = run.layout_errors
    correct, rows = check.judge(numbers, cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": bool(correct), "attempted": run.iters,
           "failed": run.failed_iters, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.wall_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {n: {"value": _finite(v), "limit": lim}
                     for n, v, lim in rows}
    bad = forbidden_modules()
    if bad:
        raise Refusal(f"modules of JAX or the JAX package loaded: {bad}")
    return out


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refusal("no CUDA device: this benchmark measures the port "
                          "on an NVIDIA GPU and never falls back to the CPU")
        if torch.cuda.device_count() < cell.chips:
            raise Refusal(f"{cell.name} needs {cell.chips} GPUs, "
                          f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        print(f"[portbench] {cell.name} seed {args.seed}: "
              f"{torch.cuda.get_device_name(device)} x "
              f"{torch.cuda.device_count()} visible, {cell.chips} used, "
              f"torch {torch.__version__}", flush=True)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device, t0)
    except Refusal as e:
        print(f"[portbench] refused: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in out["checks"].items():
        print(f"[portbench] check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0

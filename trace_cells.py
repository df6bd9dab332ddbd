"""The program's spans over untraced cycles of a benchmark cell, on the card.

    python3 trace_cells.py --workload <cell> --seed <n> [--pairs 2] \
        [--out build/trace_cells]

from the root of a checkout. It runs the cell's mode
(``portbench/modes/``) as the benchmark does, with another window: a
warm-up cycle, then ``--pairs`` pairs of whole cycles, one with tracing
off and one under ``repro_torch.tracing.enable()`` (no profiler), each
boundary a device synchronise; then one iteration under tracing and
``torch.cuda.set_sync_debug_mode("warn")``. It prints and writes to
``<out>/<cell>.json``:

- each cycle's wall time, off and on (tracing's cost when on);
- per iteration of each traced cycle, what the benchmark's span metrics
  read in a ``--trace 1`` run (``fwd_ms``, ``bwd_ms``, ``optimizer_ms``,
  ``input_ms``, ``host_syncs_per_iter``), here without the profiler;
- the host syncs the debug mode reported in the last iteration, by the
  file and line that made them, beside the program's ``sync`` counter over
  the same iteration;
- the cost of a span, a count and a timed span with tracing off, and the
  spans and counts an iteration opens, so tracing's cost when off.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench  # noqa: E402


SPAN_METRICS = ("fwd_ms", "bwd_ms", "optimizer_ms", "input_ms",
                "host_syncs_per_iter")


def per_iteration(iters):
    """The span metrics' readings (``portbench/metrics/<name>.py``) of the
    newest recording, taken as ``iters`` iterations, and its spans."""
    from repro_torch import tracing
    run = bench.Run(model={}, cycle=iters)
    out = {name: bench.read_metric(name, run) for name in SPAN_METRICS}
    out["spans"] = {k: {"count": t.count, "host_ms": 1e3 * t.host_s,
                        "self_ms": 1e3 * t.self_s,
                        "device_ms": 1e3 * t.device_s,
                        "counters": t.counters}
                    for k, t in tracing.totals().items()}
    return out


class Window(bench.Window):
    """``bench.Window``'s interface, with the cycles this script times."""

    pairs = 2
    report: dict = {}
    catcher = None

    def at_iteration(self, it):
        import torch

        from repro_torch import tracing
        if self.catcher is not None:
            torch.cuda.set_sync_debug_mode(0)
            tracing.disable()
            self.catcher.__exit__(None, None, None)
            self.report["sync_debug"] = {
                "iteration": it - 1, "reported": len(self.syncs),
                "counter": per_iteration(1)["host_syncs_per_iter"],
                "by_place": dict(collections.Counter(self.syncs))}
            return False
        if it < self.cycle or it % self.cycle:
            return True
        now = self._now()
        k = it // self.cycle - 1          # cycles done since the warm-up
        rep = self.report
        if k == 0:
            self.t_open, self.it_open, self.t_last = now, it, now
            if self.on_open:
                self.on_open(it)
        elif k <= 2 * self.pairs:
            on = k % 2 == 0               # the cycle just ended was traced
            rep.setdefault("wall_on_s" if on else "wall_off_s", []).append(
                now - self.t_last)
            if on:
                tracing.disable()
                rep.setdefault("traced", []).append(
                    per_iteration(self.cycle))
        if k < 2 * self.pairs:
            if k % 2:
                tracing.enable()
            self.t_last = self._now()
            return True
        self.t_close, self.it_close = now, it
        if self.on_close:
            self.on_close(it)
        self.syncs = []
        self.catcher = warnings.catch_warnings()
        self.catcher.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._sync_seen
        tracing.enable()
        torch.cuda.set_sync_debug_mode("warn")
        return True

    def _sync_seen(self, message, category, filename, lineno, *rest):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if "/repro_torch/" in f.filename
               or "/portbench/" in f.filename
               or f.filename == __file__]
        f = own[-1] if own else stack[-1]
        if f.filename == __file__:        # this script's own switch
            return
        self.syncs.append(f"{Path(f.filename).name}:{f.lineno} ({f.name})")


def off_cost():
    """Seconds a span, a count and a timed span take with tracing off."""
    from repro_torch import tracing

    def s():
        with tracing.span("x"):
            pass

    def t():
        with tracing.timed("x") as w:
            pass
        return w.seconds
    n = 200000
    return {name: min(timeit.repeat(f, number=n, repeat=5)) / n
            for name, f in (("span", s), ("count",
                                          lambda: tracing.count("x")),
                            ("timed", t))}


def measure(cell, seed: int, pairs: int, device) -> dict:
    """One cell's readings (the module docstring's list)."""
    import torch
    mode = importlib.import_module(f"portbench.modes.{cell.spec['mode']}")
    Window.pairs, Window.report = pairs, {}
    # the mode builds its window as bench.Window: this script's, for this
    # run only
    with mock.patch.object(bench, "Window", Window):
        run = mode.run(cell, seed, 0.0, False, device, T0)
    rep = Window.report
    totals = rep["traced"][-1]["spans"]
    opened = sum(t["count"] for t in totals.values()) / run.cycle
    # count() calls: one in each h2d and sync span, and RoPE's, which
    # count into the forward and backward spans (autograd's thread's, into
    # the recording's own) without a span of their own
    counted = (sum(totals[n]["count"] for n in ("h2d", "sync")
                   if n in totals)
               + sum(totals[n]["counters"].get("sync", 0)
                     for n in ("forward", "backward", "") if n in totals)
               ) / run.cycle
    cost = off_cost()
    return {"workload": cell.name, "seed": seed, "torch": torch.__version__,
            "cycle": run.cycle, "wall_off_s": rep["wall_off_s"],
            "wall_on_s": rep["wall_on_s"],
            "on_cost": sum(rep["wall_on_s"]) / sum(rep["wall_off_s"]) - 1,
            "traced": [{k: v for k, v in t.items() if k != "spans"}
                       for t in rep["traced"]],
            "spans_last": totals, "sync_debug": rep["sync_debug"],
            "off_cost_s": cost, "spans_per_iter": opened,
            "counts_per_iter": counted,
            "off_cost_per_iter_s": opened * cost["span"]
            + counted * cost["count"]}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--out", default="build/trace_cells")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the readings are the card's", file=sys.stderr)
        return 2
    out = measure(bench.load_cell(args.workload), args.seed, args.pairs,
                  torch.device("cuda", 0))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.workload}.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in (
        "workload", "card", "wall_off_s", "wall_on_s", "on_cost", "traced",
        "off_cost_s", "spans_per_iter", "off_cost_per_iter_s")}))
    print(json.dumps(out["sync_debug"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

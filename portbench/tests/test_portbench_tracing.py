"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.tracing``): a traced tiny run of each cell reports exactly
the ones whose ``workloads`` list it, each positive; the host syncs an
iteration are at least its micro-batches; the spans' milliseconds an
iteration fit in the traced cycle's wall time an iteration; and the run is
still ``correct``."""
import importlib
import json

import pytest

from portbench import bench
from portbench.tests.tiny import cells, run, tiny_cell

NEW = ("fwd_ms", "bwd_ms", "optimizer_ms", "input_ms", "host_syncs_per_iter")
BENCH = json.loads((bench.ROOT / "BENCHMARK.json").read_text())


class _Capture:
    """The cell's mode, keeping the ``bench.Run`` it returns."""

    def __init__(self, cell):
        self.mode = importlib.import_module(
            f"portbench.modes.{cell.spec['mode']}")
        self.got = None

    def run(self, *args):
        self.got = self.mode.run(*args)
        return self.got


@pytest.mark.parametrize("name", cells())
def test_traced_run_reports_the_span_metrics_its_cell_lists(name):
    cell = tiny_cell(name)
    cap = _Capture(cell)
    out = run(cell, mode=cap, trace=True)
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in BENCH["per_layer"]
              if m["name"] in NEW and name in m["workloads"]}
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW}
    assert set(got) == listed
    assert all(v > 0 for v in got.values()), got
    r = cap.got
    wall_ms = 1e3 * r.trace.wall_s / r.cycle
    assert sum(got.get(k, 0.0) for k in NEW[:4]) <= wall_ms, (got, wall_ms)
    if "host_syncs_per_iter" in got:
        assert got["host_syncs_per_iter"] >= len(r.traced_mbs) / r.cycle

"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the contract's shape."""
import json
import re

import pytest

from portbench import bench
from portbench.tests.tiny import cells

BENCH = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", cells())
def test_cell_resolves_to_its_files(name):
    cell = bench.load_cell(name)
    assert (bench.HERE / "modes" / f"{cell.spec['mode']}.py").exists()
    assert set(cell.limits) == {"loss_step1", "grad", "change", "layout"}
    for group in (False, True):
        for m in bench.metric_specs(cell, group):
            assert (bench.HERE / "metrics" / f"{m['name']}.py").exists()
    names = {m["name"] for m in bench.metric_specs(cell, False)}
    assert {"setup_s", "real_tokens_per_s"} <= names


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert json.loads((bench.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert set(m["workloads"]) <= set(cells())

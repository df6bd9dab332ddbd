"""The plain reference against the port's own path at a tiny size on the
CPU, in float32: each mode's first steps agree with it far inside the
cell's limits."""
import pytest

from portbench.tests.tiny import cells, run, tiny_cell

F32_AGREEMENT = 1e-5


@pytest.mark.parametrize("name", cells())
def test_port_agrees_with_the_reference(name):
    out = run(tiny_cell(name), trace=True)
    assert out["correct"], out["checks"]
    for k, c in out["checks"].items():
        if k != "layout":
            assert c["value"] < F32_AGREEMENT, out["checks"]
    assert out["checks"]["layout"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"fill_ratio", "mfu"}

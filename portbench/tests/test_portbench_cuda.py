"""On the card, at each cell's own size: the control (the reference in
fp8 put in the program's place) comes out not correct under the cell's
limits. Run on the card with ``python -m pytest -q -m cuda
portbench/tests``; skips without one."""
import pytest

from portbench import bench, check, reference, weights
from portbench.traffic import CellTraffic
from portbench.tests.tiny import cells

SEED = 2 ** 31 + 11


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_the_control_is_not_correct(card, name):
    cell = bench.load_cell(name)
    m = cell.model
    traffic = CellTraffic(cell.spec, m["vocab"], SEED)
    gbs = [traffic.batch(i) for i in range(bench.CHECK_STEPS)]

    def steps(precision):
        return reference.train_steps(
            m, weights.make_params(m, SEED, card), gbs,
            cell.spec["optimizer"], precision=precision,
            chunk_tokens=m["reference_chunk_tokens"])
    ref = steps("fp32")
    numbers = {**check.readings(steps("fp8"), ref), "layout": 0}
    correct, rows = check.judge(numbers, cell.limits)
    assert not correct, rows

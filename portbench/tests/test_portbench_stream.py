"""The frozen stream and the traffic generator: deterministic, within
their budget, the same sizes for every seed."""
import numpy as np
import pytest

from portbench import bench
from portbench.stream import MultiTaskStream, StreamConfig
from portbench.traffic import CellTraffic
from portbench.tests.tiny import cells


@pytest.mark.parametrize("name", cells())
def test_stream_is_deterministic_and_meets_its_budget(name):
    spec = bench.load_cell(name).spec
    cfg = StreamConfig(vocab=1000, **spec["stream"])
    a, b = MultiTaskStream(cfg), MultiTaskStream(cfg)
    for i in (0, 3):
        x, y = a.batch(i), b.batch(i)
        assert np.array_equal(x.lengths, y.lengths)
        assert all(np.array_equal(s, t) for s, t in zip(x.tokens, y.tokens))
        assert x.total_tokens >= cfg.global_tokens
        assert x.lengths.sum(axis=1).max() <= cfg.max_len
        if cfg.encdec_fraction == 1.0:
            assert (x.lengths[:, 1] >= 2).all()


@pytest.mark.parametrize("name", cells())
def test_every_seed_trains_the_same_sizes_in_another_order(name):
    cell = bench.load_cell(name)
    t1 = CellTraffic(cell.spec, cell.model["vocab"], 7)
    t2 = CellTraffic(cell.spec, cell.model["vocab"], 2 ** 40 + 1)
    n = t1.cycle

    def sizes(t, c):
        return sorted(tuple(map(tuple, t.batch(c * n + j).lengths))
                      for j in range(n))
    assert sizes(t1, 0) == sizes(t2, 0) == sizes(t1, 1)
    assert [t1.pool_index(j) for j in range(n)] != \
        [t2.pool_index(j) for j in range(n)]
    a, b = t1.batch(0), CellTraffic(cell.spec, cell.model["vocab"], 7).batch(0)
    assert all(np.array_equal(s, t) for s, t in zip(a.tokens, b.tokens))
    j = next(j for j in range(n, 2 * n)
             if t1.pool_index(j) == t1.pool_index(0))
    again = t1.batch(j)
    assert np.array_equal(again.lengths, a.lengths)
    assert not any(np.array_equal(s, t) for s, t in zip(a.tokens,
                                                        again.tokens))
    for t in a.tokens:
        assert t.min() >= 0 and t.max() < cell.model["vocab"]

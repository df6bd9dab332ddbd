"""The port's copies of the planning layer give results identical to the
reference's: the shape palette, the synthetic request mix, sample ordering,
the DP request batching with the serving cost, padding efficiency, the
training stream, whole-iteration plans and micro-batch materialisation."""
import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core import microbatch as jmb
from repro.core.shapes import ShapePalette as JPalette
from repro.data.synthetic import MultiTaskDataset as JDataset
from repro_torch import serve as SV
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import microbatch as tmb
from repro_torch.core.cost_model import V5E, AnalyticCostModel
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.synthetic import MultiTaskDataset

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# every module the port copies verbatim, but for ``repro.`` -> ``repro_torch.``
COPIED = sorted(str(p.relative_to(REPO / "src" / "repro"))
                for p in (REPO / "src" / "repro" / "configs").glob("*.py")) + [
    "core/cost_model.py", "core/microbatch.py", "core/shapes.py",
    "data/synthetic.py",
    "core/instructions.py", "core/schedule.py", "core/simulator.py",
    "core/comm_plan.py", "core/recompute.py", "core/planner.py",
    "core/executor.py", "analysis/__init__.py", "analysis/hb_graph.py",
    "analysis/lint.py", "analysis/memory.py", "analysis/report.py",
    "data/dataset.py", "data/streams.py", "train/step_cache.py",
    "dist/chaos.py", "dist/fault.py", "analysis/__main__.py",
    "core/packing.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_verbatim_but_for_its_imports(rel):
    ref = (REPO / "src" / "repro" / rel).read_text()
    port = (REPO / "src" / "repro_torch" / rel).read_text()
    assert port == re.sub(r"\brepro\.", "repro_torch.", ref)


def _example():
    """examples/serve_batched.py as a module (its main() is not run)."""
    spec = importlib.util.spec_from_file_location(
        "serve_batched_example", REPO / "examples" / "serve_batched.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GRID = [(n, max_len, seed) for n in (8, 24, 64) for max_len in (256, 2048)
        for seed in (3, 5)]


@pytest.mark.parametrize("n,max_len,seed", GRID)
def test_planning_identical_to_reference(n, max_len, seed):
    ex = _example()
    jcfg = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")), n_layers=2)
    tcfg = dataclasses.replace(reduced(get_arch("gpt-paper")), n_layers=2)

    jl, jt, jtid = JDataset(n_tasks=16, max_len=max_len, seed=seed) \
        .sample_minibatch(n, jcfg.vocab)
    tl, tt, ttid = MultiTaskDataset(n_tasks=16, max_len=max_len, seed=seed) \
        .sample_minibatch(n, tcfg.vocab)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ttid, jtid)
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)

    kw = dict(min_seq=32, max_seq=max_len, seq_align=32, max_mbs=16)
    assert dataclasses.astuple(ShapePalette.build(**kw)) == \
        dataclasses.astuple(JPalette.build(**kw))

    lens = jl[:, 0]
    jorder = jmb.order_samples(lens)
    torder = tmb.order_samples(lens)
    np.testing.assert_array_equal(torder, jorder)

    jbatches = jmb.dp_split(lens[jorder], ex.PrefillCost(jcfg, n_stages=1), 1,
                            palette=JPalette.build(**kw), mem_limit=1e12)
    torder2, tbatches = SV.plan_batches(tcfg, lens, max_len)
    np.testing.assert_array_equal(torder2, jorder)
    assert [dataclasses.astuple(b) for b in tbatches] == \
        [dataclasses.astuple(b) for b in jbatches]
    assert tmb.padding_efficiency(tbatches, lens[torder]) == \
        jmb.padding_efficiency(jbatches, lens[jorder])


def test_configs_identical_to_reference():
    from repro.configs.base import ARCH_IDS
    asdict = dataclasses.asdict
    for name in ARCH_IDS:
        assert asdict(get_arch(name)) == asdict(j_get_arch(name)), name
        assert asdict(reduced(get_arch(name))) == \
            asdict(j_reduced(j_get_arch(name))), name
    assert get_arch("gpt-paper").vocab_padded == 50432


def test_cost_model_default_stays_v5e():
    cfg = reduced(get_arch("gpt-paper"))
    cost = AnalyticCostModel(cfg)
    assert cost.hw is V5E and V5E.name == "tpu-v5e"
    ex = _example()
    jcost = ex.PrefillCost(j_reduced(j_get_arch("gpt-paper")), n_stages=1)
    tcost = SV.PrefillCost(cfg, n_stages=1)
    for mbs, seq in ((1, 32), (4, 256), (16, 2048)):
        assert tcost.stage_fwd_time(mbs, seq) == jcost.stage_fwd_time(mbs, seq)
        assert tcost.stage_act_memory(mbs, seq) == \
            jcost.stage_act_memory(mbs, seq)
        assert tcost.stage_bwd_time(mbs, seq) == 0.0


@pytest.mark.parametrize("encdec", [False, True], ids=["gpt", "t5"])
def test_stream_plans_and_micro_batches_identical_to_reference(encdec):
    from repro.core.cost_model import AnalyticCostModel as JCost
    from repro.core.planner import PlannerConfig as JPlannerConfig
    from repro.core.planner import plan_iteration as j_plan_iteration
    from repro.data.dataset import materialize_micro_batch as j_materialize
    from repro.data.streams import MultiTaskStream as JStream
    from repro.data.streams import StreamConfig as JStreamConfig
    from repro_torch.core.planner import PlannerConfig, plan_iteration
    from repro_torch.data.dataset import materialize_micro_batch
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    arch = "t5-paper" if encdec else "gpt-paper"
    jcfg, tcfg = j_reduced(j_get_arch(arch)), reduced(get_arch(arch))
    kw = dict(n_tasks=16, global_tokens=2048, max_len=256, vocab=512,
              encdec_fraction=1.0 if encdec else 0.0, seed=4)
    pal = dict(min_seq=32, max_seq=256, seq_align=32, max_mbs=8)
    for k in range(2):
        jb = JStream(JStreamConfig(**kw)).batch(k)
        tb = MultiTaskStream(StreamConfig(**kw)).batch(k)
        np.testing.assert_array_equal(tb.lengths, jb.lengths)
        assert all(np.array_equal(a, b) for a, b in zip(tb.tokens, jb.tokens))
        lens = jb.lengths if encdec else jb.lengths[:, 0]
        jp = j_plan_iteration(lens, JCost(jcfg, n_stages=2), JPlannerConfig(
            n_stages=2, d_model=jcfg.d_model, palette=JPalette.build(**pal)))
        tp = plan_iteration(lens, AnalyticCostModel(tcfg, n_stages=2),
                            PlannerConfig(n_stages=2, d_model=tcfg.d_model,
                                          palette=ShapePalette.build(**pal)))
        assert [p.to_json() for p in tp.replica_plans] == \
            [p.to_json() for p in jp.replica_plans]
        for m in tp.replica_plans[0].micro_batches:
            a = materialize_micro_batch(m, tb.tokens, lengths=tb.lengths)
            b = j_materialize(m, jb.tokens, lengths=jb.lengths)
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])

"""The port's threaded stage pipeline against the JAX reference's.

Config: reduced gpt-paper with 4 layers (d 64, 4 heads, 2 KV heads,
d_head 16, gelu), weights from ``repro.models.model.init_params(PRNGKey(0),
cfg)`` carried across with ``params_from_jax``, one plan of the planner
(both packages' planners give the same plan) over batches made once with
numpy. The reference runs its ``PipelinedModel`` with the ``impl="ref"``
attention; the port runs its ``PipelinedModel`` on the CPU, where the
attention takes its plain versions.

Tolerances are the reference's ``GRAD_TOL`` (tests/test_kernel_grads.py:21),
2e-4 in f32 and 4e-2 in bf16, as atol = rtol. Within the port the
pipelined loss equals the sequential loss bit for bit, the reference's own
invariant (tests/test_encdec_pipeline.py:142). The pipeline is held to the
reference in f32. In bf16 it is held to the port's sequential path: a
gradient summed over micro-batches in bf16 carries each micro-batch's
rounding at its own magnitude, so where the sum cancels, the two
frameworks' sums can differ by more than GRAD_TOL's absolute 4e-2, on the
sequential path as well as the pipelined one.
"""
import dataclasses
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.executor import PipelineExecutor as JExecutor
from repro.models import model as JM
from repro.train.pipeline_adapter import PipelinedModel as JPipelinedModel
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.executor import StageCallbacks
from repro_torch.core.instructions import ExecutionPlan
from repro_torch.core.planner import PlannerConfig, plan_iteration
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.dataset import materialize_micro_batch
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.dist.backend import ThreadsBackend
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.models import model as TM
from repro_torch.train.pipeline_adapter import PipelinedModel
from repro_torch.tree import flatten, tree_map

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = {"float32": 2e-4, "bfloat16": 4e-2}
PAL = ShapePalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
# one plan of two 4 x 64 micro-batches, at 2 and at 4 stages: one shape
# keeps the reference's stage compilations few
STREAM = StreamConfig(n_tasks=8, global_tokens=384, max_len=64, vocab=512,
                      seed=0)


def _cfgs(dtype, n_layers=4):
    j = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")),
                            n_layers=n_layers, dtype=dtype)
    t = dataclasses.replace(reduced(get_arch("gpt-paper")),
                            n_layers=n_layers, dtype=dtype)
    return j, t


def _plan(cfg, n_stages):
    gb = MultiTaskStream(STREAM).batch(0)
    pcfg = PlannerConfig(n_stages=n_stages, d_model=cfg.d_model, palette=PAL)
    plan = plan_iteration(gb.lengths[:, 0],
                          AnalyticCostModel(cfg, n_stages=n_stages),
                          pcfg).replica_plans[0]
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens,
                                                lengths=gb.lengths)
               for m in plan.micro_batches}
    return plan, batches


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_trees_close(out, ref, tol, what):
    """Every leaf of the torch tree ``out`` within tol (atol = rtol) of the
    same leaf of ``ref`` (JAX arrays or torch tensors)."""
    ref_leaves = dict(flatten(ref))
    out_leaves = dict(flatten(out))
    assert sorted(out_leaves) == sorted(ref_leaves), what
    for name, r in ref_leaves.items():
        np.testing.assert_allclose(_f32(out_leaves[name]), _f32(r), atol=tol,
                                   rtol=tol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("n_stages,dtype", [(2, "float32"), (4, "float32"),
                                            (4, "bfloat16")])
def test_pipelined_model_matches_reference_and_sequential(n_stages, dtype):
    jcfg, tcfg = _cfgs(dtype)
    plan, batches = _plan(tcfg, n_stages)
    assert plan.n_stages == n_stages and len(plan.micro_batches) >= 2
    jparams = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tol = GRAD_TOL[dtype]

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    before = {k: v.clone() for k, v in flatten(tparams)}
    pipe = ThreadsBackend(tcfg, n_stages, device="cpu")
    assert isinstance(pipe.pm, PipelinedModel)
    res = pipe.execute_plan(plan, params=tparams, batches=batches,
                            collect_timings=True)
    seq = ThreadsBackend(tcfg, n_stages, use_executor=False, device="cpu")
    assert seq.pm is None
    sres = seq.execute_plan(plan, params=tparams, batches=batches)

    loss = res.loss_sum / res.weight_sum
    assert res.weight_sum == sres.weight_sum
    assert loss == sres.loss_sum / sres.weight_sum       # bit for bit
    assert_trees_close(res.grads, sres.grads, tol, "pipelined vs sequential")
    if dtype == "float32":
        jpm = JPipelinedModel(jcfg, jparams, n_stages, impl="ref")
        cbs, jres = jpm.make_callbacks(
            ExecutionPlan.from_json(plan.to_json()), batches)
        JExecutor(plan, cbs, timeout=120).run()
        np.testing.assert_allclose(
            loss, jres["loss_sum"] / jres["weight_sum"], rtol=tol, atol=tol)
        assert res.weight_sum == jres["weight_sum"]
        assert_trees_close(res.grads,
                           jpm.merge_stage_grads(jres["stage_grads"]), tol,
                           "pipelined vs reference")
    for name, g in flatten(res.grads):
        assert g.dtype == before[name].dtype, name
    assert all(torch.equal(before[k], v) for k, v in flatten(tparams))
    # every stage timed each micro-batch once forward and once backward
    n = len(plan.micro_batches) * n_stages
    kinds = [kind for kind, _, _ in res.timings]
    assert kinds.count("f") == kinds.count("b") == n
    # the step cache keys are the reference's: (kind, namespace, stage,
    # mbs, seq), a forward and a backward step per stage and shape
    shapes = {(m.mbs, m.seq) for m in plan.micro_batches}
    fwd = pipe.step_cache.keys_for("fwd")
    assert len(fwd) == n_stages * len(shapes) == pipe.step_cache.count("bwd")
    assert {k[3:] for k in fwd} == shapes and all(len(k) == 5 for k in fwd)


def test_stage_params_cover_the_model_and_tied_embedding_grads_sum():
    _, tcfg = _cfgs("float32")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    pm = PipelinedModel(tcfg, params, 2)
    s0, s1 = pm.stage_params(0), pm.stage_params(1)
    assert set(s0) == {"stack", "embed"}
    assert set(s1) == {"stack", "final_norm"} | (
        {"embed"} if tcfg.tie_embeddings else {"head"})
    for (_, a), (_, b), (_, full) in zip(flatten(s0["stack"]),
                                         flatten(s1["stack"]),
                                         flatten(params["stack"])):
        assert torch.equal(torch.cat([a, b]), full)
    with pytest.raises(ValueError, match="not divisible"):
        PipelinedModel(tcfg, params, 3)
    # merge: stack slices in place, shared tensors summed in stage order
    out = pm.merge_stage_grads([tree_map(torch.ones_like, s0),
                                tree_map(lambda x: torch.full_like(x, 2.0),
                                         s1)])
    assert sorted(k for k, _ in flatten(out)) == sorted(
        k for k, _ in flatten(params))
    k = pm.k
    for _, x in flatten(out["stack"]):
        assert (x[:k] == 1).all() and (x[k:] == 2).all()
    assert (out["embed"] == (3 if tcfg.tie_embeddings else 1)).all()


def test_threads_backend_callbacks_path():
    """``execute_plan(plan, callbacks=...)`` is the raw host plane: the
    caller's stage callbacks on the executor."""
    _, tcfg = _cfgs("float32")
    plan, _ = _plan(tcfg, 1)
    log = []
    cbs = [StageCallbacks(
        forward=lambda mb, *a: log.append(("f", mb)),
        backward=lambda mb, g: log.append(("b", mb)),
        step=lambda: None)]
    res = ThreadsBackend(tcfg, 1, device="cpu").execute_plan(
        plan, callbacks=cbs)
    assert res.grads is None and res.loss_sum == 0.0
    ids = {m.mb_id for m in plan.micro_batches}
    assert {mb for kind, mb in log if kind == "f"} == ids
    assert {mb for kind, mb in log if kind == "b"} == ids


def test_launch_counters_are_exact_under_threads():
    """The kernels' launch counters are bumped from every stage thread: no
    increment may be lost."""
    n_threads, per_thread = 8, 2000
    ops.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(per_thread):
                _build.count_launch(tfa.LAUNCHES, "mha_forward")
                _build.count_launch(tfa.LAUNCHES, "mha_backward")
                _build.count_launch(tssd.LAUNCHES, "ssd_chunked")
                _build.count_launch(tssd.LAUNCHES, "ssd_backward")
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    n = n_threads * per_thread
    assert ops.launch_counts() == {"mha_forward": n, "mha_backward": n,
                                   "ssd_chunked": n, "ssd_backward": n}
    ops.reset_launch_counts()


def test_launch_train_cli_runs_the_pipeline_at_its_defaults():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--iters", "2", "--tokens", "512", "--max-seq", "64"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "loss: first5=" in out.stdout and "nan" not in out.stdout

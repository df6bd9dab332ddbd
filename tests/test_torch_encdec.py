"""The port's encoder-decoder (T5) against the JAX reference: the model,
its sequential grad step, the pipelined stage layout and the runner on a
2-D ``(enc, dec)`` stream.

Config: reduced t5-paper with 2 + 2 layers (d 64, 4 heads, 2 KV heads,
d_head 16, relu), the reference's own test config
(tests/test_encdec_pipeline.py:27), weights from
``repro.models.transformer.init_encdec`` carried across with
``params_from_jax``, micro-batches of the planner over the reference
test's stream. The reference runs its ``impl="ref"`` attention; the port's
CPU path runs the plain versions.

Tolerances are the reference's ``GRAD_TOL`` (tests/test_kernel_grads.py:21),
2e-4 in f32 and 4e-2 in bf16, as atol = rtol; the pipelined loss equals
the sequential loss bit for bit within the port, as in the reference
(tests/test_encdec_pipeline.py:142). Gradients summed over several
micro-batches are held to the reference in f32 (see
tests/test_torch_pipeline.py for why not in bf16), and so is one
micro-batch's: at this config's gradient magnitudes the bf16 gradients of
both packages lie about as far from the f32 gradient of the same weights
as from each other, past GRAD_TOL's 4e-2 + 4e-2 |g| on some elements; the
bf16 case holds the decoder states and the loss.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.executor import PipelineExecutor as JExecutor
from repro.models import transformer as JT
from repro.train.pipeline_adapter import (
    EncDecPipelinedModel as JEncDecPipelinedModel, _xent_sum as j_xent_sum,
    build_encdec_grad_step as j_build_encdec_grad_step)
from repro.train.runner import PlanAheadRunner as JRunner
from repro.train.runner import RunnerConfig as JRunnerConfig
from repro.core.cost_model import AnalyticCostModel as JCost
from repro.core.planner import PlannerConfig as JPlannerConfig
from repro.core.shapes import ShapePalette as JPalette
from repro.data.streams import MultiTaskStream as JStream
from repro.data.streams import StreamConfig as JStreamConfig
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.instructions import ExecutionPlan
from repro_torch.core.planner import PlannerConfig, plan_iteration
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.dataset import materialize_micro_batch
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.dist.backend import ThreadsBackend
from repro_torch.models import transformer as TT
from repro_torch.train.pipeline_adapter import (EncDecPipelinedModel,
                                                build_encdec_grad_step)
from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import flatten
from test_torch_pipeline import assert_trees_close

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = {"float32": 2e-4, "bfloat16": 4e-2}
# the reference test's palette with at most 4 rows: two micro-batches per
# global batch, so the pipeline has more than one in flight
PAL_ARGS = dict(min_seq=32, max_seq=128, seq_align=32, max_mbs=4)
STREAM_ARGS = dict(n_tasks=8, global_tokens=512, max_len=96, vocab=512,
                   encdec_fraction=1.0, seed=3)


def _cfgs(dtype="float32", n_layers=2):
    j = dataclasses.replace(j_reduced(j_get_arch("t5-paper")),
                            n_layers=n_layers, dtype=dtype)
    t = dataclasses.replace(reduced(get_arch("t5-paper")),
                            n_layers=n_layers, dtype=dtype)
    return j, t


def _init(cfg, seed=0):
    return jax.jit(JT.init_encdec, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _plan(cfg, n_stages):
    gb = MultiTaskStream(StreamConfig(**STREAM_ARGS)).batch(0)
    pcfg = PlannerConfig(n_stages=n_stages, d_model=cfg.d_model,
                         palette=ShapePalette.build(**PAL_ARGS))
    plan = plan_iteration(gb.lengths, AnalyticCostModel(cfg, n_stages=n_stages),
                          pcfg).replica_plans[0]
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens,
                                                lengths=gb.lengths)
               for m in plan.micro_batches}
    return plan, batches


def test_init_encdec_tree_crosses_with_the_ports_layout():
    jcfg, tcfg = _cfgs("bfloat16")
    jparams = _init(jcfg)
    tparams = params_from_jax(_np(jparams), device="cpu")
    own = TT.init_encdec(torch.Generator().manual_seed(0), tcfg, device="cpu")
    carried = {k: (tuple(v.shape), v.dtype) for k, v in flatten(tparams)}
    assert carried == {k: (tuple(v.shape), v.dtype) for k, v in flatten(own)}
    assert carried[("cross", "attn", "wq")][0][0] == tcfg.n_periods
    jflat = dict(flatten(jparams))
    for k, v in flatten(tparams):       # the bits crossed unchanged
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(jflat[k], np.float32),
                                      err_msg=str(k))
    for name in ("enc_norm", "dec_norm"):
        assert (own[name] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_fwd_and_grad_step_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    plan, batches = _plan(tcfg, 1)
    b = batches[min(batches)]
    jparams = _init(jcfg, seed=1)
    tparams = params_from_jax(_np(jparams), device="cpu")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    kw = ("enc_segments", "enc_segment_ids"), ("dec_segments",
                                               "dec_segment_ids"), \
        ("enc_positions", "enc_positions"), ("dec_positions", "dec_positions")
    jhd = JT.encdec_fwd(jparams, jb["enc_tokens"], jb["dec_tokens"], jcfg,
                        impl="ref", **{a: jb[k] for a, k in kw})
    thd = TT.encdec_fwd(tparams, tb["enc_tokens"], tb["dec_tokens"], tcfg,
                        **{a: tb[k] for a, k in kw})
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(thd.float().numpy(),
                               np.asarray(jhd, np.float32), atol=tol, rtol=tol)
    tl, tw, tg = build_encdec_grad_step(tcfg)(tparams, tb)
    # the oracle's loss is the summed xent of its decoder states
    jls, jws = j_xent_sum(jparams["embed"], jhd, jb["labels"],
                          jb["loss_weights"], jcfg)
    np.testing.assert_allclose(float(tl), float(jls), rtol=tol, atol=tol)
    assert float(tw) == float(jws) > 0
    if dtype == "float32":
        jl, jw, jg = j_build_encdec_grad_step(jcfg, impl="ref")(jparams, jb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=tol, atol=tol)
        assert_trees_close(tg, jg, tol, "grad")
    assert sorted(k for k, _ in flatten(tg)) == sorted(
        k for k, _ in flatten(tparams))


def test_layout_and_stage_params_cover_the_model():
    _, tcfg = _cfgs()
    assert EncDecPipelinedModel.layout(tcfg, 2) == (2, 1)
    assert EncDecPipelinedModel.layout(tcfg, 4) == (1, 2)
    for bad in (3, 1):
        with pytest.raises(ValueError):
            EncDecPipelinedModel.layout(tcfg, bad)
    cfg3 = dataclasses.replace(tcfg, n_layers=3)
    assert EncDecPipelinedModel.layout(cfg3, 2) == (3, 1)
    with pytest.raises(ValueError, match="straddles"):
        EncDecPipelinedModel.layout(cfg3, 3)
    params = TT.init_encdec(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    pm = EncDecPipelinedModel(tcfg, params, 4)
    kinds = [set(pm.stage_params(j)) for j in range(4)]
    assert kinds == [{"stack", "embed"}, {"stack", "enc_norm"},
                     {"stack", "cross", "embed"},
                     {"stack", "cross", "embed", "dec_norm"}]
    # merge: every leaf of the model once, the embedding summed over the
    # three stages that hold it
    out = pm.merge_stage_grads([
        {k: _ones(v, j + 1) for k, v in pm.stage_params(j).items()}
        for j in range(4)])
    assert sorted(k for k, _ in flatten(out)) == sorted(
        k for k, _ in flatten(params))
    assert (out["embed"] == 1 + 3 + 4).all()
    for key, first in (("enc", 1), ("dec", 3), ("cross", 3)):
        for _, x in flatten(out[key]):
            assert (x[0] == first).all() and (x[1] == first + 1).all()


def _ones(tree, value):
    if isinstance(tree, dict):
        return {k: _ones(v, value) for k, v in tree.items()}
    return torch.full_like(tree, float(value))


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_encdec_matches_reference_and_sequential(n_stages):
    """Loss and every gradient leaf against the reference's
    ``EncDecPipelinedModel`` on the same plan; the loss equal to the bit to
    the port's sequential oracle; cross-attention gradients reach the
    encoder through the he leg of the payload."""
    jcfg, tcfg = _cfgs("float32")
    plan, batches = _plan(tcfg, n_stages)
    assert all(isinstance(m.seq, tuple) for m in plan.micro_batches)
    assert len(plan.micro_batches) >= 2
    jparams = _init(jcfg)
    jpm = JEncDecPipelinedModel(jcfg, jparams, n_stages, impl="ref")
    cbs, jres = jpm.make_callbacks(ExecutionPlan.from_json(plan.to_json()),
                                   batches)
    JExecutor(plan, cbs, timeout=120).run()
    jgrads = jpm.merge_stage_grads(jres["stage_grads"])

    tparams = params_from_jax(_np(jparams), device="cpu")
    pipe = ThreadsBackend(tcfg, n_stages, device="cpu")
    assert isinstance(pipe.pm, EncDecPipelinedModel)
    res = pipe.execute_plan(plan, params=tparams, batches=batches)
    seq = ThreadsBackend(tcfg, n_stages, use_executor=False, device="cpu")
    sres = seq.execute_plan(plan, params=tparams, batches=batches)

    tol = GRAD_TOL["float32"]
    loss = res.loss_sum / res.weight_sum
    assert loss == sres.loss_sum / sres.weight_sum     # bit for bit
    np.testing.assert_allclose(loss, jres["loss_sum"] / jres["weight_sum"],
                               rtol=tol, atol=tol)
    assert res.weight_sum == jres["weight_sum"] == sres.weight_sum
    assert_trees_close(res.grads, jgrads, tol, "pipelined vs reference")
    assert_trees_close(res.grads, sres.grads, tol, "pipelined vs sequential")
    # the loss lives on the decoder side: encoder gradients come only
    # through cross-attention
    assert max(float(g.abs().max()) for _, g in flatten(res.grads["enc"])) > 0
    keys = pipe.step_cache.keys_for("bwd")
    assert keys and all(len(k) == 6 for k in keys)


def _port_runner(cfg, n_stages, params=None, step_cache=None, **kw):
    pcfg = PlannerConfig(n_stages=n_stages, d_model=cfg.d_model,
                         palette=ShapePalette.build(**PAL_ARGS))
    rcfg = RunnerConfig(n_iters=2, log_every=0, device="cpu", **kw)
    return PlanAheadRunner(cfg, AnalyticCostModel(cfg, n_stages=n_stages),
                           pcfg, rcfg, MultiTaskStream(StreamConfig(
                               **STREAM_ARGS)),
                           params=params, step_cache=step_cache)


def test_synchronous_runner_trajectory_matches_reference():
    """The runner on a 2-D stream, pipelined over 2 stages, against the
    reference's runner: the same split and token counts, losses and grad
    norms within the f32 GRAD_TOL."""
    jcfg, tcfg = _cfgs("float32")
    jpcfg = JPlannerConfig(n_stages=2, d_model=jcfg.d_model,
                           palette=JPalette.build(**PAL_ARGS))
    jrcfg = JRunnerConfig(n_iters=2, log_every=0, synchronous=True,
                          impl="ref", seed=0)
    _, jhist, _ = JRunner(jcfg, JCost(jcfg, n_stages=2), jpcfg, jrcfg,
                          JStream(JStreamConfig(**STREAM_ARGS))).run()
    params = params_from_jax(_np(_init(jcfg, seed=0)), device="cpu")
    _, thist, stats = _port_runner(tcfg, 2, params=params,
                                   synchronous=True).run()
    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        keys = ("iter", "n_micro", "tokens", "padded_tokens")
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-4)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=2e-4)
    assert stats.faults == 0


def test_plan_ahead_equals_synchronous_on_a_2d_stream():
    """Double-buffered planning changes when plans are made, never what
    runs: losses and params equal to the bit through the enc-dec pipeline,
    every stage step keyed (kind, namespace, stage, mbs, enc, dec)."""
    _, tcfg = _cfgs("float32")
    shared = CompiledStepCache()
    runs = []
    for sync in (False, True):
        params = TT.init_encdec(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
        runs.append(_port_runner(tcfg, 2, params=params, step_cache=shared,
                                 synchronous=sync).run())
    (p0, h0, s0), (p1, h1, s1) = runs
    assert s0.mode == "plan-ahead" and s1.mode == "synchronous"
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]
    assert all(np.isfinite(h["loss"]) for h in h0)
    for (name, a), (_, b) in zip(flatten(p0), flatten(p1)):
        assert torch.equal(a, b), name
    pal = ShapePalette.build(**PAL_ARGS)
    fwd = shared.keys_for("fwd")
    assert fwd and all(len(k) == 6 for k in fwd)
    assert all(k[3] in pal.mbs_buckets and k[4] in pal.seq_buckets
               and k[5] in pal.seq_buckets for k in fwd)


def test_runner_refuses_decoder_only_micro_batches_for_encdec():
    _, tcfg = _cfgs("float32")
    pcfg = PlannerConfig(n_stages=2, d_model=tcfg.d_model,
                         palette=ShapePalette.build(**PAL_ARGS))
    stream = MultiTaskStream(StreamConfig(**dict(STREAM_ARGS,
                                                 encdec_fraction=0.0)))
    runner = PlanAheadRunner(tcfg, AnalyticCostModel(tcfg, n_stages=2), pcfg,
                             RunnerConfig(n_iters=1, log_every=0,
                                          synchronous=True, device="cpu"),
                             stream)
    with pytest.raises(ValueError, match="decoder-only"):
        runner.run()


def test_launch_train_cli_trains_t5():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--arch", "t5-paper", "--iters", "2", "--tokens", "512",
         "--max-seq", "64"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "loss: first5=" in out.stdout and "nan" not in out.stdout

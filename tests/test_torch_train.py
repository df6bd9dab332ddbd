"""The port's training slice against the JAX reference.

Config: reduced gpt-paper (d 64, 4 heads, 2 KV heads, d_head 16, gelu),
weights from ``repro.models.model.init_params(PRNGKey(0), cfg)`` carried
across with ``params_from_jax``, batches made once with numpy. The
reference runs its ``impl="ref"`` attention (its jnp oracle); the port's
CPU path runs the plain versions of K1, K2 and K3.

Tolerances are the reference's ``GRAD_TOL`` (tests/test_kernel_grads.py:21):
2e-4 in f32 (summation order) and 4e-2 in bf16 (the frameworks round to
bf16 at different points), applied as atol = rtol.
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
from repro.core.cost_model import AnalyticCostModel as JCost
from repro.core.planner import PlannerConfig as JPlannerConfig
from repro.core.shapes import ShapePalette as JPalette
from repro.data.streams import MultiTaskStream as JStream
from repro.data.streams import StreamConfig as JStreamConfig
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train.pipeline_adapter import build_grad_step as j_build_grad_step
from repro.train.runner import PlanAheadRunner as JRunner
from repro.train.runner import RunnerConfig as JRunnerConfig
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.kernels import ops
from repro_torch.train import optimizer as TO
from repro_torch.train.pipeline_adapter import build_grad_step
from repro_torch.train.runner import PlanAheadRunner, RunnerConfig

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = {"float32": 2e-4, "bfloat16": 4e-2}


def _init(cfg, seed=0):
    """The reference's init, jitted: one compilation, not one per leaf."""
    return jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)


def _cfgs(dtype):
    j = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")), dtype=dtype)
    t = dataclasses.replace(reduced(get_arch("gpt-paper")), dtype=dtype)
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_trees_close(out, ref, tol, what):
    ref_leaves = dict(_flat(ref))
    out_leaves = dict(_flat(out))
    assert sorted(out_leaves) == sorted(ref_leaves), what
    for name, r in ref_leaves.items():
        np.testing.assert_allclose(_f32(out_leaves[name]), _f32(r), atol=tol,
                                   rtol=tol, err_msg=f"{what} {name}")


def _batch(vocab):
    """Two rows of 64: a sample of 64 tokens, and one of 40 then padding
    (segment -1), as ``materialize_micro_batch`` lays them out."""
    r = np.random.default_rng(5)
    b, t = 2, 64
    tokens = np.zeros((b, t), np.int32)
    labels = np.zeros((b, t), np.int32)
    weights = np.zeros((b, t), np.float32)
    positions = np.zeros((b, t), np.int32)
    seg = np.full((b, t), -1, np.int32)
    for row, n in enumerate((64, 40)):
        s = r.integers(0, vocab, n)
        tokens[row, :n] = s
        labels[row, :n - 1] = s[1:]
        weights[row, :n - 1] = 1.0
        positions[row, :n] = np.arange(n)
        seg[row, :n] = 0
    return {"tokens": tokens, "labels": labels, "loss_weights": weights,
            "positions": positions, "segment_ids": seg}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_step_loss_and_every_gradient_leaf_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jparams = _init(jcfg)
    batch = _batch(jcfg.vocab)
    jl, jw, jg = j_build_grad_step(jcfg, impl="ref")(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(_np(jparams), device="cpu")
    before = {k: v.clone() for k, v in _flat(tparams)}
    tl, tw, tg = build_grad_step(tcfg)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol, atol=tol)
    assert float(tw) == float(jw) == 63 + 39
    _assert_trees_close(tg, jg, tol, "grad")
    for name, g in _flat(tg):      # dtypes follow the params; params untouched
        assert g.dtype == before[name].dtype, name
    assert all(torch.equal(before[k], v) for k, v in _flat(tparams))


def test_adamw_steps_from_the_same_gradients_give_the_same_masters():
    jcfg, _ = _cfgs("bfloat16")
    jparams = _init(jcfg, seed=1)
    # jitted: one compilation each instead of one per leaf shape
    ocfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    j_init = jax.jit(JO.init_opt_state, static_argnums=1)
    jstate = j_init(jparams, JO.AdamWConfig(**ocfg))
    tparams = params_from_jax(_np(jparams), device="cpu")
    tstate = TO.init_opt_state(tparams, TO.AdamWConfig(**ocfg))
    j_update = jax.jit(JO.adamw_update, static_argnums=3)
    r = np.random.default_rng(2)
    for step in range(5):
        # gradients far above the clip norm, then below it
        scale = 10.0 if step < 3 else 1e-4
        grads_np = jax.tree.map(
            lambda p: (r.standard_normal(p.shape) * scale).astype(np.float32),
            _np(jparams))
        jg = jax.tree.map(lambda g: jnp.asarray(g.astype(jnp.bfloat16)),
                          grads_np)
        tg = params_from_jax(_np(jg), device="cpu")
        jparams, jstate, jm = j_update(jparams, jg, jstate,
                                       JO.AdamWConfig(**ocfg))
        tparams, tstate, tm = TO.adamw_update(tparams, tg, tstate,
                                              TO.AdamWConfig(**ocfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == 5
    _assert_trees_close(tstate["master"], jstate["master"], 1e-6, "master")
    _assert_trees_close(tstate["m"], jstate["m"], 1e-6, "m")
    _assert_trees_close(tstate["v"], jstate["v"], 1e-6, "v")
    # bf16 copies of masters that agree to 1e-6: a master on a rounding
    # boundary may round either way, one bf16 ulp (2^-7 relative) apart
    for (name, a), (_, b) in zip(_flat(tparams), _flat(jparams)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6, rtol=2 ** -7,
                                   err_msg=name)
    # the bf16 error-feedback compression of the DP reduce
    ccfg = dict(ocfg, compress_grads=True)
    jc, jcs = jax.jit(JO.compress_for_reduce, static_argnums=2)(
        jg, j_init(jparams, JO.AdamWConfig(**ccfg)), JO.AdamWConfig(**ccfg))
    tc, tcs = TO.compress_for_reduce(
        tg, TO.init_opt_state(tparams, TO.AdamWConfig(**ccfg)),
        TO.AdamWConfig(**ccfg))
    _assert_trees_close(tc, jc, 0.0, "compressed")
    _assert_trees_close(tcs["err"], jcs["err"], 0.0, "err")


def _stream_args():
    return dict(n_tasks=8, global_tokens=512, max_len=64, vocab=512,
                tail_fraction=0.1, tail_alpha=1.2, seed=0)


def _port_runner(cfg, params, **kw):
    stream = MultiTaskStream(StreamConfig(**_stream_args()))
    pal = ShapePalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
    pcfg = PlannerConfig(n_stages=1, d_model=cfg.d_model, palette=pal)
    rcfg = RunnerConfig(n_iters=3, use_executor=False, log_every=0,
                        device="cpu", **kw)
    return PlanAheadRunner(cfg, AnalyticCostModel(cfg, n_stages=1), pcfg,
                           rcfg, stream, params=params)


def test_synchronous_runner_trajectory_matches_reference():
    jcfg, tcfg = _cfgs("float32")
    stream = JStream(JStreamConfig(**_stream_args()))
    pal = JPalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
    pcfg = JPlannerConfig(n_stages=1, d_model=jcfg.d_model, palette=pal)
    rcfg = JRunnerConfig(n_iters=3, use_executor=False, log_every=0,
                         synchronous=True, impl="ref", seed=0)
    _, jhist, _ = JRunner(jcfg, JCost(jcfg, n_stages=1), pcfg, rcfg,
                          stream).run()
    jparams0 = JM.init_params(jax.random.PRNGKey(0), jcfg)   # the runner's
    ops.reset_launch_counts()
    _, thist, stats = _port_runner(
        tcfg, params_from_jax(_np(jparams0), device="cpu"),
        synchronous=True).run()
    assert len(thist) == len(jhist) == 3
    assert any(h["n_micro"] > 1 for h in thist)       # accumulation ran
    for t, j in zip(thist, jhist):
        assert {k: t[k] for k in ("iter", "n_micro", "tokens", "padded_tokens")} \
            == {k: j[k] for k in ("iter", "n_micro", "tokens", "padded_tokens")}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-4)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=2e-4)
    assert sorted(thist[0]) == sorted(jhist[0])       # the same history keys
    assert stats.mode == "synchronous" and stats.iters == 3
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions


def test_plan_ahead_equals_synchronous_bit_for_bit():
    _, tcfg = _cfgs("float32")
    runs = []
    for sync in (True, False):
        gen = torch.Generator().manual_seed(3)
        from repro_torch.models import model as TM
        params = TM.init_params(gen, tcfg, device="cpu")
        params, hist, stats = _port_runner(tcfg, params,
                                           synchronous=sync).run()
        runs.append((params, hist, stats))
    (p0, h0, s0), (p1, h1, s1) = runs
    assert s0.mode == "synchronous" and s1.mode == "plan-ahead"
    for a, b in zip(h0, h1):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    for (name, a), (_, b) in zip(_flat(p0), _flat(p1)):
        assert torch.equal(a, b), name


def test_launch_train_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--stages", "1", "--iters", "1", "--tokens", "512",
         "--max-seq", "64"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "loss: first5=" in out.stdout


def test_loss_fn_matches_reference():
    jcfg, tcfg = _cfgs("float32")
    jparams = _init(jcfg)
    batch = _batch(jcfg.vocab)
    jloss, _ = JM.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                          jcfg, impl="ref")
    from repro_torch.models import model as TM
    tparams = params_from_jax(_np(jparams), device="cpu")
    leaf = tparams["head"].requires_grad_()
    tloss, parts = TM.loss_fn(tparams, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-4)
    assert float(parts["moe_aux"]) == 0.0
    tloss.backward()      # through the recomputed loss chunks
    assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0


@pytest.mark.parametrize("b,t,max_tokens,n_chunks", [
    (4, 96, 64, 6),       # 16 positions a chunk: the token bound
    (2, 1024, 4096, 2),   # 512 positions a chunk: LOSS_CHUNK
    (3, 40, 2048, 1),     # the whole micro-batch in one chunk
    (5, 2048, 2048, 8),   # 409 tokens a row, rounded down to 256
])
def test_xent_sum_in_chunks_matches_the_references_whole_micro_batch(
        monkeypatch, b, t, max_tokens, n_chunks):
    # the training step's xent over a micro-batch, taken in chunks of at
    # most LOSS_CHUNK positions and LOSS_TOKENS tokens, against the
    # reference's _xent_sum, which takes the micro-batch's logits at once:
    # the sums and the gradients of h and of the head
    from repro.train.pipeline_adapter import _xent_sum as j_xent_sum
    from repro_torch.models import model as TM
    monkeypatch.setattr(TM, "LOSS_TOKENS", max_tokens)
    cfg = dataclasses.replace(reduced(get_arch("gemma2-2b")), dtype="float32")
    r = np.random.default_rng(2)
    h = r.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    head = (0.3 * r.standard_normal((cfg.vocab_padded, cfg.d_model))
            ).astype(np.float32)
    labels = r.integers(0, cfg.vocab, (b, t), dtype=np.int32)
    weights = (r.random((b, t)) < 0.8).astype(np.float32)
    (jl, jw), jg = jax.value_and_grad(
        lambda hd, x: j_xent_sum(hd, x, jnp.asarray(labels),
                                 jnp.asarray(weights), cfg),
        argnums=(0, 1), has_aux=True)(jnp.asarray(head), jnp.asarray(h))
    th, thead = (torch.from_numpy(x).requires_grad_() for x in (h, head))
    chunks = []
    xent_chunk = TM._xent_chunk
    monkeypatch.setattr(TM, "_xent_chunk",
                        lambda *a: chunks.append(a[1].shape[1]) or xent_chunk(*a))
    tl, tw = TM.xent_sums(thead, th, torch.from_numpy(labels),
                          torch.from_numpy(weights), cfg)
    assert chunks == [t // n_chunks] * n_chunks   # the forward's chunks
    tl.backward()
    assert float(tw) == float(jw)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    for out, ref in ((thead.grad, jg[0]), (th.grad, jg[1])):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-4)


def test_strict_verification_raises_until_ported():
    # strict verification is ported (ROADMAP A4): the backend and the
    # runner take it, and the backend refuses a plan the verifier flags
    # instead of running it
    from repro_torch.core.executor import PlanRejectedError
    from repro_torch.core.instructions import ExecutionPlan, Instr, Op
    from repro_torch.dist.backend import make_backend
    _, tcfg = _cfgs("float32")
    backend = make_backend("threads", tcfg, 1, use_executor=False,
                           strict=True, device="cpu")
    assert backend.strict
    _, hist, _ = _port_runner(tcfg, None, strict_verify=True).run()
    assert len(hist) == 3
    bad = ExecutionPlan(n_stages=2, micro_batches=[], per_stage=[
        [Instr(Op.SEND_ACT_START, 0, peer=1)], []])
    with pytest.raises(PlanRejectedError):
        backend.execute_plan(bad, params=None, batches={})


def test_stage_pipeline_and_unported_features_raise():
    _, tcfg = _cfgs("float32")
    from repro_torch.dist.backend import ThreadsBackend, make_backend
    from repro_torch.dist.chaos import FaultSchedule
    from repro_torch.train.pipeline_adapter import PipelinedModel
    # the stage pipeline (ROADMAP A9) is ported: 2 stages over the 2
    # periods run it
    assert isinstance(ThreadsBackend(tcfg, 2, use_executor=True,
                                     device="cpu").pm, PipelinedModel)
    # the mesh backend (ROADMAP A13) is ported: built and run on the CPU
    from repro_torch.dist.backend import MeshBackend
    assert isinstance(make_backend("mesh", tcfg, 1, device="cpu"),
                      MeshBackend)
    _, hist, _ = _port_runner(tcfg, None, backend="mesh").run()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    # checkpoints (A10), fault injection (A12) and the process fault
    # domain (A14, tests/test_torch_cluster.py) are ported: the runner
    # takes them
    _port_runner(tcfg, None, ckpt_dir="x")
    assert _port_runner(tcfg, None,
                        fault_domain="process").rcfg.fault_domain == "process"
    PlanAheadRunner(tcfg, None, PlannerConfig(n_stages=1),
                    RunnerConfig(device="cpu"), None, chaos=FaultSchedule([]))
    # the sequential fallback the reference also takes: stages that do not
    # divide the periods, or no executor
    assert ThreadsBackend(tcfg, 2, use_executor=False, device="cpu").pm is None
    assert ThreadsBackend(tcfg, 3, use_executor=True, device="cpu").pm is None

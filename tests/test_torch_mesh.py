"""The port's stage-mesh device plane: ``dist/pipeline.py``, ``MeshBackend``
and ZeRO-1, on the CPU.

The reference's mesh tests (tests/test_exec_backend.py) on the port, at its
sizes (reduced gpt-paper, 2 layers; 4 for the 4-stage ring): the plan's
injection order; a 1-stage mesh against the threads backend's sequential
path, loss, weight and every gradient leaf equal to the bit on one shape
group and the loss to the bit on a planner plan of several; the hook fired
once per micro-batch in ring order; the step cache bounded by the
palette; the rejections; the empty plan; the runner's trajectory, its
first loss to the bit. The reference's 4-device subprocess test runs
here in one process on a ``["cpu"] * 4`` stage mesh: against the port's
threads backend within the reference's own tolerances (loss rtol 1e-8,
gradients rtol 2e-4 / atol 1e-5), against the *reference's* threaded
pipeline at 4 stages in f32 within GRAD_TOL (2e-4, atol = rtol,
tests/test_kernel_grads.py:21), invariant to the injection order, and
the ZeRO-1 placement round trip with its update equal to
``adamw_update``'s to the bit. ``pipelined_apply`` is held to the
reference's within 1e-5. Last, a state-losing crash under
``backend="mesh"`` with checkpoints replays to the fault-free run's
state, and its checkpoint loads in the reference's ``checkpoint.load``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.executor import PipelineExecutor as JExecutor
from repro.dist import pipeline as JP
from repro.models import model as JM
from repro.train import checkpoint as JCKPT
from repro.train import train_state as JTS
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.pipeline_adapter import PipelinedModel as JPipelinedModel
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.instructions import (ExecutionPlan, Instr,
                                           MicroBatchSpec, Op,
                                           RecomputePolicy)
from repro_torch.core.planner import PlannerConfig, plan_iteration
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.dataset import materialize_micro_batch
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.dist import pipeline as TP
from repro_torch.dist.backend import (BackendResult, MeshBackend,
                                      ThreadsBackend, make_backend)
from repro_torch.dist.chaos import FaultEvent, FaultKind, FaultSchedule
from repro_torch.dist.sharding import ZeroShards, axis_map
from repro_torch.launch.mesh import make_host_mesh, make_stage_mesh
from repro_torch.models import model as TM
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
from repro_torch.train.step_cache import CompiledStepCache
from repro_torch.tree import flatten, leaves, tree_map

torch.set_num_threads(1)

CFG = dataclasses.replace(reduced(get_arch("gpt-paper")), n_layers=2)
CFG4 = dataclasses.replace(CFG, n_layers=4)
PAL = ShapePalette.build(min_seq=32, max_seq=128, seq_align=32, max_mbs=8)
GRAD_TOL = 2e-4


def _mesh(n):
    return make_stage_mesh(n, devices=["cpu"] * n)


def _mesh_backend(cfg, n, **kw):
    return make_backend("mesh", cfg, n, mesh=_mesh(n), **kw)


def _params(cfg, seed=0):
    return TM.init_params(torch.Generator().manual_seed(seed), cfg,
                          device="cpu")


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close(a, b, rtol=2e-4, atol=1e-5):
    for (ka, x), (kb, y) in zip(flatten(a), flatten(b)):
        assert ka == kb
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=str(ka))


def _rand_batch(rng, mbs, seq, vocab):
    return {
        "tokens": rng.integers(1, vocab, (mbs, seq)).astype(np.int32),
        "labels": rng.integers(1, vocab, (mbs, seq)).astype(np.int32),
        "loss_weights": np.ones((mbs, seq), np.float32),
        "positions": np.tile(np.arange(seq, dtype=np.int32), (mbs, 1)),
        "segment_ids": np.zeros((mbs, seq), np.int32),
    }


def _hand_plan(shapes, order=None):
    specs = [MicroBatchSpec(mb_id=i, sample_indices=[], mbs=m, seq=s,
                            t_fwd=1.0, t_bwd=2.0, mem=0.0)
             for i, (m, s) in enumerate(shapes)]
    stream = [Instr(Op.FORWARD, i) for i in range(len(shapes))] + \
             [Instr(Op.BACKWARD, i) for i in reversed(range(len(shapes)))]
    meta = {} if order is None else {"injection_order": list(order)}
    return ExecutionPlan(n_stages=1, micro_batches=specs, per_stage=[stream],
                         recompute=RecomputePolicy.FULL, meta=meta)


def _planner_plan(cfg=CFG, n_stages=1, seed=0, tokens=1024):
    stream = MultiTaskStream(StreamConfig(
        seed=seed, global_tokens=tokens, max_len=128, vocab=cfg.vocab))
    gb = stream.batch(0)
    pcfg = PlannerConfig(n_stages=n_stages, d_model=cfg.d_model, palette=PAL)
    cost = AnalyticCostModel(cfg, n_stages=n_stages)
    plan = plan_iteration(gb.lengths[:, 0], cost, pcfg).replica_plans[0]
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens,
                                                lengths=gb.lengths)
               for m in plan.micro_batches}
    return plan, batches


# ---------------------------------------------------------------------------
# injection order
# ---------------------------------------------------------------------------
def test_injection_order_meta_wins_else_the_stage0_scan():
    assert TP.injection_order(_hand_plan([(2, 32)] * 3, order=[2, 0, 1])) \
        == [2, 0, 1]
    assert TP.injection_order(_hand_plan([(2, 32)] * 3)) == [0, 1, 2]
    plan, _ = _planner_plan()
    assert sorted(plan.meta["injection_order"]) == sorted(
        m.mb_id for m in plan.micro_batches)
    assert TP.injection_order(plan) == [int(i) for i in
                                        plan.meta["injection_order"]]


# ---------------------------------------------------------------------------
# 1-stage mesh against the threads backend
# ---------------------------------------------------------------------------
def test_mesh_bitwise_parity_single_group():
    """One shape group of 3 micro-batches: loss, weight and every gradient
    leaf equal to the threads backend's to the bit; no filler
    micro-batch, so ``m_pad`` is the real count."""
    rng = np.random.default_rng(0)
    plan = _hand_plan([(2, 64)] * 3)
    batches = {i: _rand_batch(rng, 2, 64, 200) for i in range(3)}
    params = _params(CFG)
    r_t = make_backend("threads", CFG, 1, use_executor=False,
                       device="cpu").execute_plan(plan, params=params,
                                                  batches=batches)
    # the mesh a caller on the CPU gets by default: its device, once
    mesh = make_backend("mesh", CFG, 1, device="cpu")
    assert isinstance(mesh, MeshBackend)
    assert [str(d) for d in mesh.mesh.devices] == ["cpu"]
    r_m = mesh.execute_plan(plan, params=params, batches=batches)
    assert r_t.loss_sum == r_m.loss_sum
    assert r_t.weight_sum == r_m.weight_sum
    assert _equal(r_t.grads, r_m.grads)
    assert r_m.meta["groups"] == [
        {"mbs": 2, "seq": 64, "n_micro": 3, "m_pad": 3}]


def test_mesh_loss_bitwise_on_planner_plan():
    plan, batches = _planner_plan()
    assert len({(m.mbs, m.seq) for m in plan.micro_batches}) > 1
    params = _params(CFG, 1)
    r_t = make_backend("threads", CFG, 1, use_executor=False,
                       device="cpu").execute_plan(plan, params=params,
                                                  batches=batches)
    r_m = _mesh_backend(CFG, 1).execute_plan(plan, params=params,
                                             batches=batches)
    assert r_t.loss_sum == r_m.loss_sum
    assert r_t.weight_sum == r_m.weight_sum
    _close(r_m.grads, r_t.grads)


def test_mesh_timings_and_hook_order():
    plan, batches = _planner_plan()
    seen = []
    res = _mesh_backend(CFG, 1).execute_plan(
        plan, params=_params(CFG), batches=batches,
        hook=lambda s, i: seen.append((s, i.op, i.micro_batch)),
        collect_timings=True)
    assert seen == [(0, Op.FORWARD, m) for m in TP.injection_order(plan)]
    assert sorted(mb for _, mb, _ in res.timings) == sorted(batches)
    assert all(k == "total" and s > 0 for k, _, s in res.timings)


def test_mesh_step_cache_bounded_by_palette():
    """The eager ring has one cache entry per (mbs, seq): the reference's
    bound (palette shapes x power-of-two counts) holds with room."""
    cache = CompiledStepCache()
    mesh = _mesh_backend(CFG, 1, step_cache=cache)
    params = _params(CFG)
    shapes = set()
    for seed in range(3):
        plan, batches = _planner_plan(seed=seed)
        shapes |= {(m.mbs, m.seq) for m in plan.micro_batches}
        mesh.execute_plan(plan, params=params, batches=batches)
    keys = cache.keys_for("mesh")
    assert keys and len(keys) == cache.count("mesh") == len(shapes)
    assert len(keys) <= len(PAL.mbs_buckets) * len(PAL.seq_buckets)
    assert {k[-2:] for k in keys} == shapes
    for key in keys:
        assert key[-2] in PAL.mbs_buckets and key[-1] in PAL.seq_buckets
    before = cache.misses
    plan, batches = _planner_plan(seed=0)
    mesh.execute_plan(plan, params=params, batches=batches)
    assert cache.misses == before


def test_mesh_backend_rejections():
    plan = _hand_plan([(1, 8)])
    mesh = _mesh_backend(CFG, 1)
    with pytest.raises(ValueError, match="threads"):
        mesh.execute_plan(plan, callbacks=[object()])
    with pytest.raises(NotImplementedError):
        make_backend("mesh", reduced(get_arch("t5-paper")), 1,
                     mesh=_mesh(1))
    with pytest.raises(NotImplementedError, match="input_mode"):
        make_backend("mesh", reduced(get_arch("hubert-xlarge")), 1,
                     mesh=_mesh(1))
    with pytest.raises(ValueError, match="not divisible"):
        make_backend("mesh", CFG, 3, mesh=_mesh(3))
    with pytest.raises(ValueError, match="expected n_stages=2"):
        make_backend("mesh", CFG, 2, mesh=_mesh(1))
    with pytest.raises(ValueError, match="unknown execution backend"):
        make_backend("gpu", CFG, 1, device="cpu")
    # no mesh and no card: nothing falls back to the CPU
    with pytest.raises(ValueError, match="need 2 devices"):
        make_backend("mesh", CFG, 2)
    with pytest.raises(ValueError, match="need 4 devices"):
        make_stage_mesh(4)
    with pytest.raises(ValueError, match="need 1 devices"):
        make_host_mesh()


def test_empty_plan_is_noop_on_both_backends():
    plan = ExecutionPlan(n_stages=1, micro_batches=[], per_stage=[[]],
                         meta={"injection_order": []})
    for name in ("threads", "mesh"):
        res = make_backend(name, CFG, 1, use_executor=False,
                           device="cpu").execute_plan(plan, params=None,
                                                      batches={})
        assert isinstance(res, BackendResult)
        assert res.grads is None and res.loss_sum == 0.0


def _trajectory(backend, n_iters=3, mesh=None, **kw):
    pcfg = PlannerConfig(n_stages=1, d_model=CFG.d_model, palette=PAL)
    stream = MultiTaskStream(StreamConfig(
        seed=0, global_tokens=1024, max_len=128, vocab=CFG.vocab))
    rcfg = RunnerConfig(n_iters=n_iters, synchronous=True, log_every=0,
                        use_executor=False, backend=backend, device="cpu",
                        **kw)
    runner = PlanAheadRunner(CFG, AnalyticCostModel(CFG, n_stages=1), pcfg,
                             rcfg, stream, opt_cfg=AdamWConfig(lr=1e-2),
                             mesh=mesh)
    params, hist, stats = runner.run()
    return params, [h["loss"] for h in hist], stats, runner


def test_runner_backend_selection_mesh_vs_threads():
    _, l_thr, _, _ = _trajectory("threads")
    _, l_mesh, stats, runner = _trajectory("mesh")
    assert isinstance(runner.backend, MeshBackend)
    assert l_thr[0] == l_mesh[0], "first-step loss must be bit-identical"
    np.testing.assert_allclose(l_thr, l_mesh, rtol=1e-5)
    assert all(np.isfinite(l) for l in l_mesh)
    assert stats.cache["entries"] > 0


def test_zero_logical_axis_resolves_to_stage_mesh():
    amap = axis_map(_mesh(1))
    assert amap["zero"] == ("stage",)
    assert amap["dp"] == () and amap["tp"] == ()


# ---------------------------------------------------------------------------
# the 4-stage ring in one process
# ---------------------------------------------------------------------------
def test_mesh_4stage_against_threads_and_injection_order():
    plan, batches = _planner_plan(CFG4, 4)
    assert plan.n_stages == 4 and len(plan.micro_batches) > 1
    params = _params(CFG4)
    r_t = ThreadsBackend(CFG4, 4, use_executor=False,
                         device="cpu").execute_plan(plan, params=params,
                                                    batches=batches)
    r_p = ThreadsBackend(CFG4, 4, device="cpu").execute_plan(
        plan, params=params, batches=batches)
    mesh = _mesh_backend(CFG4, 4)
    assert [str(d) for d in mesh.devices] == ["cpu"] * 4
    r_m = mesh.execute_plan(plan, params=params, batches=batches)
    for ref in (r_t, r_p):
        np.testing.assert_allclose(r_m.loss_sum, ref.loss_sum, rtol=1e-8)
        assert r_m.weight_sum == ref.weight_sum
        _close(r_m.grads, ref.grads)
    # another injection order: other hand-offs, the same loss (summed on
    # the host in mb_id order) and close gradients
    perm = list(reversed([m.mb_id for m in plan.micro_batches]))
    plan2 = dataclasses.replace(plan, meta=dict(plan.meta,
                                                injection_order=perm))
    r_r = mesh.execute_plan(plan2, params=params, batches=batches)
    assert r_r.loss_sum == r_m.loss_sum
    _close(r_r.grads, r_m.grads)


def test_mesh_4stage_against_the_references_threaded_pipeline():
    """f32, the reference's PipelinedModel (its ``impl="ref"`` attention)
    on the same plan and weights."""
    jcfg = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")),
                               n_layers=4, dtype="float32")
    tcfg = dataclasses.replace(CFG4, dtype="float32")
    stream = MultiTaskStream(StreamConfig(n_tasks=8, global_tokens=384,
                                          max_len=64, vocab=512, seed=0))
    gb = stream.batch(0)
    pal = ShapePalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
    plan = plan_iteration(
        gb.lengths[:, 0], AnalyticCostModel(tcfg, n_stages=4),
        PlannerConfig(n_stages=4, d_model=tcfg.d_model, palette=pal)
    ).replica_plans[0]
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens,
                                                lengths=gb.lengths)
               for m in plan.micro_batches}
    jparams = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    res = _mesh_backend(tcfg, 4).execute_plan(plan, params=tparams,
                                              batches=batches)
    jpm = JPipelinedModel(jcfg, jparams, 4, impl="ref")
    cbs, jres = jpm.make_callbacks(plan, batches)
    JExecutor(plan, cbs, timeout=120).run()
    assert res.weight_sum == jres["weight_sum"]
    np.testing.assert_allclose(res.loss_sum / res.weight_sum,
                               jres["loss_sum"] / jres["weight_sum"],
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    ref = dict(flatten(jax.tree.map(np.asarray,
                                    jpm.merge_stage_grads(
                                        jres["stage_grads"]))))
    got = dict(flatten(res.grads))
    assert sorted(got) == sorted(ref)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(k))


def test_zero1_placement_round_trip_and_update_to_the_bit():
    plan, batches = _planner_plan(CFG4, 4)
    params = _params(CFG4)
    mesh = _mesh_backend(CFG4, 4)
    grads = mesh.execute_plan(plan, params=params, batches=batches).grads
    ocfg = AdamWConfig(lr=1e-2)
    opt = init_opt_state(params, ocfg)
    copy = tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, opt)
    placed = mesh.place_opt_state(copy)
    assert placed is copy and placed["step"] == 0
    n_split = 0
    for (path, ref), (_, leaf) in zip(flatten(opt), flatten(placed)):
        if isinstance(leaf, ZeroShards):
            n_split += 1
            assert len(leaf.chunks) == 4 and leaf.shape == ref.shape
            assert all(c.is_contiguous() for c in leaf.chunks)
            assert torch.equal(leaf.whole(), ref), path
        elif torch.is_tensor(leaf):
            assert torch.equal(leaf, ref), path
    assert n_split == 3 * len(leaves(params)), "ZeRO-1 split nothing"
    assert mesh.place_opt_state(placed) is placed       # placed already

    p_ref = tree_map(torch.clone, params)
    for _ in range(2):          # two steps: m and v carried in the chunks
        p_ref, opt, m_ref = adamw_update(p_ref, grads, opt, ocfg)
        params, placed, m_got = mesh.optimizer_step(params, grads, placed,
                                                    ocfg)
        assert torch.equal(m_ref["grad_norm"], m_got["grad_norm"])
        assert _equal(p_ref, params)
        for key in ("master", "m", "v"):
            for a, b in zip(leaves(opt[key]), leaves(placed[key])):
                assert torch.equal(a, b.whole()), key
    assert placed["step"] == opt["step"] == 2


def test_pipelined_apply_matches_the_references():
    rng = np.random.default_rng(0)
    n_stages, n_micro = 2, 3
    w = rng.standard_normal((n_stages, 16, 16)).astype(np.float32) * 0.3
    b = rng.standard_normal((n_stages, 16)).astype(np.float32)
    xs = rng.standard_normal((n_micro, 4, 16)).astype(np.float32)
    ref = JP.pipelined_apply(
        lambda p, h, s: jnp.tanh(h @ p["w"] + p["b"]),
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(xs),
        n_stages=n_stages)
    tw = {"w": torch.as_tensor(w), "b": torch.as_tensor(b)}

    def stage_fn(p, h, s):
        return torch.tanh(h @ p["w"] + p["b"])
    plan = dataclasses.replace(_hand_plan([(4, 16)] * n_micro,
                                          order=[2, 0, 1]), n_stages=2)
    for kw in ({}, {"mesh": _mesh(2)}, {"mesh": _mesh(2), "plan": plan}):
        out = TP.pipelined_apply(stage_fn, tw, torch.as_tensor(xs), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=str(kw))


# ---------------------------------------------------------------------------
# a checkpoint under the mesh
# ---------------------------------------------------------------------------
def _mesh_run(ckpt_dir, chaos=None):
    pcfg = PlannerConfig(n_stages=2, d_model=CFG.d_model,
                         palette=ShapePalette.build(min_seq=32, max_seq=128,
                                                    seq_align=32, max_mbs=8))
    rcfg = RunnerConfig(n_iters=4, backend="mesh", log_every=0,
                        ckpt_dir=str(ckpt_dir), ckpt_every=2,
                        retry_backoff_s=0.01, device="cpu")
    runner = PlanAheadRunner(
        CFG, AnalyticCostModel(CFG, n_stages=2), pcfg, rcfg,
        MultiTaskStream(StreamConfig(n_tasks=8, global_tokens=512,
                                     max_len=128, vocab=CFG.vocab, seed=5)),
        opt_cfg=AdamWConfig(lr=1e-2), chaos=chaos, mesh=_mesh(2))
    params, hist, stats = runner.run()
    return params, hist, stats, runner.opt_state


def test_state_losing_crash_under_the_mesh_replays_and_loads_in_the_reference(
        tmp_path):
    chaos = FaultSchedule([FaultEvent(3, FaultKind.STAGE_CRASH, stage=0,
                                      state_lost=True)])
    p_fault, h_fault, s_fault, o_fault = _mesh_run(tmp_path / "a", chaos)
    p_free, h_free, _, o_free = _mesh_run(tmp_path / "b")
    restores = [r for r in s_fault.recoveries
                if r["kind"] == "checkpoint_restore"]
    assert restores and restores[0]["restored_step"] == 2
    assert [h["iter"] for h in h_fault] == [0, 1, 2, 2, 3]
    last = {h["iter"]: (h["loss"], h["grad_norm"]) for h in h_fault}
    assert last == {h["iter"]: (h["loss"], h["grad_norm"]) for h in h_free}
    assert _equal(p_fault, p_free)
    for key in ("master", "m", "v"):
        assert all(isinstance(x, ZeroShards) for x in leaves(o_fault[key]))
        assert all(torch.equal(a.whole(), b.whole()) for a, b in
                   zip(leaves(o_fault[key]), leaves(o_free[key])))

    # the step-4 checkpoint: whole leaves, the reference's format
    jcfg = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")),
                               n_layers=2)
    like = JTS.state_shapes(jcfg, JAdamWConfig(lr=1e-2))
    state, manifest = JCKPT.load(tmp_path / "a", like, 4)
    assert manifest["step"] == 4
    ours = {"params": p_fault, "opt": o_fault}
    got = dict(flatten(jax.tree.map(np.asarray, state)))
    mine = dict(flatten(ours))
    assert sorted(got) == sorted(mine)
    for path, x in mine.items():
        ref = np.asarray(got[path])
        if isinstance(x, ZeroShards):
            x = x.whole()
        if torch.is_tensor(x):       # bf16 and fp32 both exact in fp32
            x, ref = x.float().numpy(), ref.astype(np.float32)
        np.testing.assert_array_equal(ref, x, err_msg=str(path))


# ---------------------------------------------------------------------------
# a stage mesh with a further axis
# ---------------------------------------------------------------------------
_STAGE_MODEL_CODE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
import repro
from jax.sharding import Mesh
from repro.configs.base import get_arch, reduced
from repro.core.cost_model import AnalyticCostModel
from repro.core.planner import PlannerConfig, plan_iteration
from repro.core.shapes import ShapePalette
from repro.data.dataset import materialize_micro_batch
from repro.data.streams import MultiTaskStream, StreamConfig
from repro.dist.backend import make_backend
from repro.launch.mesh import make_stage_mesh
from repro.models import model as MD
from repro.train.optimizer import AdamWConfig, init_opt_state

cfg = dataclasses.replace(reduced(get_arch("gpt-paper")), n_layers=2,
                          dtype="float32")
gb = MultiTaskStream(StreamConfig(n_tasks=8, global_tokens=384, max_len=64,
                                  vocab=512, seed=0)).batch(0)
pal = ShapePalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
plan = plan_iteration(gb.lengths[:, 0], AnalyticCostModel(cfg, n_stages=2),
                      PlannerConfig(n_stages=2, d_model=cfg.d_model,
                                    palette=pal)).replica_plans[0]
batches = {m.mb_id: materialize_micro_batch(m, gb.tokens, lengths=gb.lengths)
           for m in plan.micro_batches}
params = MD.init_params(jax.random.PRNGKey(0), cfg)
two = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("stage", "model"))
runs = {}
for name, mesh in (("2x2", two), ("2", make_stage_mesh(2))):
    runs[name] = make_backend("mesh", cfg, 2, mesh=mesh).execute_plan(
        plan, params=params, batches=batches)
a, b = runs["2x2"], runs["2"]
same = bool(a.loss_sum == b.loss_sum and a.weight_sum == b.weight_sum
            and all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
                    zip(jax.tree.leaves(a.grads), jax.tree.leaves(b.grads))))
# no gradient is split over the model axis: the stack's over the stages,
# the rest whole
replicated = all("model" not in jax.tree.leaves(tuple(x.sharding.spec))
                 for x in jax.tree.leaves(a.grads))
placed = make_backend("mesh", cfg, 2, mesh=two).place_opt_state(
    init_opt_state(params, AdamWConfig(lr=1e-2)))
dims = [next((i for i, e in enumerate(x.sharding.spec) if e is not None), -1)
        for x in jax.tree.leaves(placed["m"])]
flat = {}
def walk(tree, prefix):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            walk(tree[k], prefix + "/" + k)
        else:
            flat[prefix + "/" + k] = np.asarray(tree[k])
walk(params, "params")
walk(a.grads, "grad")
np.savez(sys.argv[1] if len(sys.argv) > 1 else OUT, **flat)
print("RESULT", json.dumps({"same": same, "replicated": replicated,
                            "loss_sum": a.loss_sum, "weight_sum": a.weight_sum,
                            "zero_dims": dims}))
"""


def test_a_stage_model_mesh_equals_the_stage_mesh_and_the_reference(
        tmp_path):
    """The reference's ``MeshBackend`` takes a mesh whose first axis is the
    stage axis and holds a replica of each stage on every further axis. On
    a ``("stage", "model")`` (2, 2) mesh of ``["cpu"] * 4`` the port equals
    its (2,) mesh to the bit, loss, weight and every gradient leaf, and its
    ZeRO-1 state splits over the stage axis alone, along the dims the
    reference's placement picks, the update equal on both meshes to the
    bit. The reference on the same meshes (4 host devices): its (2, 2) run
    equals its (2,) run to the bit, no gradient split over the model axis,
    and the port's run equals it in f32 within GRAD_TOL."""
    from tests.conftest import run_subprocess_devices
    from repro_torch.launch.mesh import make_mesh
    out = run_subprocess_devices(
        f"OUT = {str(tmp_path / 'ref.npz')!r}\n" + _STAGE_MODEL_CODE,
        n_devices=4, timeout=600)
    res = json.loads(next(x for x in out.splitlines()
                          if x.startswith("RESULT "))[len("RESULT "):])
    assert res["same"] and res["replicated"]
    arrays = dict(np.load(tmp_path / "ref.npz"))

    def tree(prefix):
        t: dict = {}
        for k, v in arrays.items():
            parts = k.split("/")
            if parts[0] != prefix:
                continue
            node = t
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return t

    cfg = dataclasses.replace(CFG, dtype="float32")
    gb = MultiTaskStream(StreamConfig(n_tasks=8, global_tokens=384,
                                      max_len=64, vocab=512, seed=0)).batch(0)
    pal = ShapePalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
    plan = plan_iteration(
        gb.lengths[:, 0], AnalyticCostModel(cfg, n_stages=2),
        PlannerConfig(n_stages=2, d_model=cfg.d_model, palette=pal)
    ).replica_plans[0]
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens,
                                                lengths=gb.lengths)
               for m in plan.micro_batches}
    params = params_from_jax(tree("params"), device="cpu")
    two = make_mesh((2, 2), ("stage", "model"),
                    devices=[f"cpu:{i}" for i in range(4)])
    backends = {"2x2": make_backend("mesh", cfg, 2, mesh=two),
                "2": make_backend("mesh", cfg, 2, mesh=_mesh(2))}
    assert [str(d) for d in backends["2x2"].devices] == ["cpu:0", "cpu:2"]
    runs = {k: b.execute_plan(plan, params=params, batches=batches)
            for k, b in backends.items()}
    a, b = runs["2x2"], runs["2"]
    assert a.loss_sum == b.loss_sum and a.weight_sum == b.weight_sum
    assert _equal(a.grads, b.grads)
    assert a.weight_sum == res["weight_sum"]
    np.testing.assert_allclose(a.loss_sum, res["loss_sum"], rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    ref = dict(flatten(tree("grad")))
    got = dict(flatten(a.grads))
    assert sorted(got) == sorted(ref)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(k))

    # ZeRO-1 on both meshes: the same chunks, the same update
    ocfg = AdamWConfig(lr=1e-2)
    out_params = {}
    for name, backend in backends.items():
        placed = backend.place_opt_state(init_opt_state(params, ocfg))
        m = leaves(placed["m"])
        assert [x.dim if isinstance(x, ZeroShards) else -1 for x in m] \
            == res["zero_dims"]
        assert all(len(x.chunks) == 2 for x in m if isinstance(x, ZeroShards))
        p = tree_map(torch.clone, params)
        out_params[name] = backend.optimizer_step(p, a.grads, placed,
                                                  ocfg)[0]
    assert _equal(out_params["2x2"], out_params["2"])

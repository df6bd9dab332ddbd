"""Every architecture of ``configs/`` through the port against the JAX
reference, at ``reduced(...)`` widths, mirroring tests/test_arch_smoke.py:
``forward``, ``loss_fn`` (with ``moe_aux``), ``build_grad_step``'s
gradients, prefill and decode against a full forward, and the stage
pipeline for one MoE and one ``frames`` model.

Configs: each architecture's ``reduced`` config (d 64, 4 heads, d_head 16;
MoE 4 experts of width 64, top-k at most 2; jamba one 8-layer period of
mamba, attention and MoE) at float32, so the comparison sees the algorithm
and not bf16 rounding. Weights are the reference's ``init_params``
carried across with ``params_from_jax``; batches are made with numpy. The
reference runs with ``impl="ref"`` (its plain attention and SSD), the port
on the CPU, where attention and the SSD take their plain versions.
t5-paper is the encoder-decoder of tests/test_torch_encdec.py. gemma2-2b
also runs at its own head dim, 256 (the one the CUDA kernels' D 256 forms
take), with the other widths reduced: forward, loss, gradients, and
prefill and decode against the reference's.

Tolerance 2e-4 (atol = rtol), the reference's f32 ``GRAD_TOL``
(tests/test_kernel_grads.py:21), for the loss, the aux term, the hidden
states and every gradient leaf: the two frameworks sum in other orders.
MoE routes are compared exactly first, since a flipped route would move a
token by a whole expert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.train.pipeline_adapter import build_grad_step as j_grad_step
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.executor import PipelineExecutor
from repro_torch.core.planner import PlannerConfig, plan_iteration
from repro_torch.core.shapes import ShapePalette
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train.pipeline_adapter import PipelinedModel, build_grad_step
from repro_torch.tree import add_into, flatten

torch.set_num_threads(1)

TOL = 2e-4
ARCHS = [a for a in ARCH_IDS if a != "t5-paper"]
KEY = jax.random.PRNGKey(0)


def _cfgs(arch, **kw):
    j = dataclasses.replace(j_reduced(j_get_arch(arch)), dtype="float32",
                            **kw)
    t = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    return j, t


def make_batch(cfg, b=2, s=32, seed=0):
    """The reference smoke test's batch in numpy: frames and a 20% mask,
    or patches then tokens, or tokens; labels, unit weights, positions
    0..s-1 and segment 0."""
    r = np.random.default_rng(seed)
    batch = {}
    if cfg.input_mode == "frames":
        batch["frames"] = r.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
        batch["mask"] = r.random((b, s)) < 0.2
    elif cfg.input_mode == "mixed":
        batch["patches"] = r.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        batch["tokens"] = r.integers(0, cfg.vocab, (b, s - cfg.n_patches),
                                     dtype=np.int32)
    else:
        batch["tokens"] = r.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    batch["labels"] = r.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    batch["loss_weights"] = np.ones((b, s), np.float32)
    batch["positions"] = np.broadcast_to(np.arange(s, dtype=np.int32),
                                         (b, s)).copy()
    batch["segment_ids"] = np.zeros((b, s), np.int32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(out, ref, what, tol=TOL):
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol,
                               err_msg=what)


def _trees_close(out, ref, what):
    ref_leaves, out_leaves = dict(flatten(ref)), dict(flatten(out))
    assert sorted(out_leaves) == sorted(ref_leaves), what
    for name, r in ref_leaves.items():
        _close(out_leaves[name], r, f"{what} {name}")


def _params(jcfg):
    jparams = JM.init_params(KEY, jcfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _routes(jparams, tparams, batch, jcfg, tcfg):
    """Each MoE layer's top-k experts for every token, from the reference
    (its router, softmax and top_k on the hidden state entering the layer)
    and from the port's ``moe_route`` as the forward calls it."""
    got = []
    real = TL.moe_route

    def record(xf, router, cfg):
        out = real(xf, router, cfg)
        got.append(out[2].numpy())
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "moe_route", record)
        TM.forward(tparams, _torch(batch), tcfg, remat=False)

    want = []

    def j_moe(p, x, cfg):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(xf @ p["router"], axis=-1)
        jax.debug.callback(lambda t: want.append(np.asarray(t)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return j_moe_real(p, x, cfg)
    j_moe_real = JL.moe_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "moe_fwd", j_moe)
        jax.block_until_ready(jax.jit(lambda p, bt: JM.forward(
            p, bt, jcfg, impl="ref", remat=False)[0])(jparams, _jax(batch)))
        jax.effects_barrier()
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    _check_forward_loss_and_grads(arch)


def _check_forward_loss_and_grads(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jparams, tparams = _params(jcfg)
    batch = make_batch(tcfg)
    tb = _torch(batch)

    if tcfg.has_moe:     # routes first: equal, choice for choice
        got, want = _routes(jparams, tparams, batch, jcfg, tcfg)
        assert len(got) == len(want) == sum(s.moe for s in tcfg.pattern_layers)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def j_fwd_loss(p, bt):
        h, _, aux = JM.forward(p, bt, jcfg, impl="ref")
        return h, aux, JM.loss_fn(p, bt, jcfg, impl="ref")
    jh, jaux, (jloss, jparts) = jax.jit(j_fwd_loss)(jparams, _jax(batch))
    th, _, taux = TM.forward(tparams, tb, tcfg)
    assert th.shape == (2, 32, tcfg.d_model)
    _close(th, jh, f"{arch} forward h")
    tloss, tparts = TM.loss_fn(tparams, tb, tcfg)
    _close(tloss, jloss, f"{arch} loss")
    _close(tparts["moe_aux"], jparts["moe_aux"], f"{arch} moe_aux")
    _close(taux, jaux, f"{arch} forward aux")
    if tcfg.has_moe:
        assert float(tparts["moe_aux"]) > 0
        assert float(tloss) != float(TM.lm_loss(tparams, th, tb["labels"],
                                                tb["loss_weights"], tcfg))
    else:
        assert float(tparts["moe_aux"]) == 0.0

    jls, jws, jg = j_grad_step(jcfg, impl="ref")(jparams, _jax(batch))
    tls, tws, tg = build_grad_step(tcfg)(tparams, tb)
    assert float(tws) == float(jws)
    _close(tls, jls, f"{arch} grad step loss sum")
    _trees_close(tg, jg, f"{arch} grad step")
    for name, g in flatten(tg):
        assert torch.isfinite(g).all(), name


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_arch(a).decode])
def test_prefill_decode_matches_full_forward(arch):
    """decode(S | prefill(..S)) against a full forward over S + 1 positions,
    at no-drop capacity (a 1-token decode group and a full sequence drop
    differently, GShard semantics). A mixed model prefills its patches and
    the first text tokens, then decodes the next token."""
    _, tcfg = _cfgs(arch, capacity_factor=16.0)
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    b, s = 2, 24
    full = _torch(make_batch(tcfg, b=b, s=s + 1))
    h_full, _, _ = TM.forward(params, full, tcfg, mode="train", remat=False)
    want = TM._last_logits(params, h_full, tcfg)
    pb = {"positions": full["positions"][:, :s],
          "tokens": full["tokens"][:, :-1]}
    if tcfg.input_mode == "mixed":
        pb["patches"] = full["patches"]
    _, cache = TM.prefill(params, pb, tcfg, cache_len=s + 1)
    got, _ = TM.decode(params, {
        "tokens": full["tokens"][:, -1:],
        "positions": torch.full((b, 1), s, dtype=torch.int32),
        "cache": cache, "cache_pos": s}, tcfg)
    _close(got, want, f"{arch} decode vs full forward", tol=2e-3)


def test_gemma2_at_head_dim_256_matches_reference():
    """gemma2-2b at its own head dim (256), its other widths reduced
    (window 32, softcaps 50 and 30): forward, loss and gradients, then a
    prefill of 24 tokens and one decode step, each logit against the
    reference's ``prefill`` and ``decode``."""
    _check_forward_loss_and_grads("gemma2-2b", d_head=256)
    jcfg, tcfg = _cfgs("gemma2-2b", d_head=256)
    assert tcfg.d_head == 256 and tcfg.attn_softcap and tcfg.final_softcap
    jparams, tparams = _params(jcfg)
    b, s = 2, 24
    full = make_batch(tcfg, b=b, s=s + 1, seed=3)
    pb = {"positions": full["positions"][:, :s], "tokens": full["tokens"][:, :-1]}
    db = {"tokens": full["tokens"][:, -1:],
          "positions": np.full((b, 1), s, np.int32)}
    j_logits, j_cache = jax.jit(lambda p, bt: JM.prefill(
        p, bt, jcfg, impl="ref", cache_len=s + 1))(jparams, _jax(pb))
    t_logits, t_cache = TM.prefill(tparams, _torch(pb), tcfg, cache_len=s + 1)
    _close(t_logits, j_logits, "gemma2 d_head 256 prefill logits")
    j_dec, _ = jax.jit(lambda p, bt: JM.decode(p, bt, jcfg, impl="ref"))(
        jparams, dict(_jax(db), cache=j_cache,
                      cache_pos=jnp.asarray(s, jnp.int32)))
    t_dec, _ = TM.decode(tparams, dict(_torch(db), cache=t_cache,
                                       cache_pos=s), tcfg)
    _close(t_dec, j_dec, "gemma2 d_head 256 decode logits")
    assert float(t_dec.abs().max()) <= tcfg.final_softcap


def test_encoder_only_prefill_is_the_full_forward():
    # hubert: no decode step; prefill runs the train-mode forward, no cache
    _, tcfg = _cfgs("hubert-xlarge")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    batch = _torch(make_batch(tcfg))
    logits, cache = TM.prefill(params, batch, tcfg)
    h, _, _ = TM.forward(params, batch, tcfg, remat=False)
    assert cache is None
    assert torch.equal(logits, TM._last_logits(params, h, tcfg))
    assert set(params) == {"embed", "stack", "final_norm", "frame_adapter",
                           "mask_emb", "head"}
    # a masked frame enters as mask_emb, whatever its features
    emb = TM.embed_inputs(params, batch, tcfg)
    m = batch["mask"]
    assert m.any() and torch.equal(emb[m], params["mask_emb"].expand(
        int(m.sum()), -1))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "hubert-xlarge"])
def test_two_stage_pipeline_equals_the_sequential_step(arch):
    """One plan of two micro-batches over a 2-stage PipelinedModel (stage 0
    holds the embedding and, for hubert, the frame adapter and mask
    embedding) against ``build_grad_step`` summed over the same
    micro-batches: the loss to the bit, every gradient leaf within TOL."""
    _, tcfg = _cfgs(arch, n_layers=4)
    pal = ShapePalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
    pcfg = PlannerConfig(n_stages=2, d_model=tcfg.d_model, palette=pal)
    lengths = np.array([64, 60, 50, 40, 33, 30, 20, 12])
    plan = plan_iteration(lengths, AnalyticCostModel(tcfg, n_stages=2),
                          pcfg).replica_plans[0]
    assert len(plan.micro_batches) >= 2
    batches = {m.mb_id: make_batch(tcfg, b=m.mbs, s=m.seq, seed=m.mb_id)
               for m in plan.micro_batches}
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    pm = PipelinedModel(tcfg, params, 2)
    assert set(pm.stage_params(0)) - {"stack"} == (
        {"embed", "frame_adapter", "mask_emb"}
        if tcfg.input_mode == "frames" else {"embed"})
    cbs, res = pm.make_callbacks(plan, batches)
    PipelineExecutor(plan, cbs, timeout=120).run()
    grads = pm.merge_stage_grads(res["stage_grads"])

    step = build_grad_step(tcfg)
    seq_grads, loss_sum, w_sum = None, 0.0, 0.0
    for mb in sorted(batches):
        ls, ws, g = step(params, _torch(batches[mb]))
        loss_sum += float(ls)
        w_sum += float(ws)
        seq_grads = g if seq_grads is None else add_into(seq_grads, g)
    assert res["weight_sum"] == w_sum
    assert res["loss_sum"] / res["weight_sum"] == loss_sum / w_sum  # to the bit
    _trees_close(grads, seq_grads, f"{arch} pipelined vs sequential")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "hubert-xlarge",
                                  "llava-next-34b"])
def test_params_cross_from_the_reference_bit_for_bit(arch):
    # the fp32 router and the bf16 adapters and mask embedding keep their
    # dtypes and bits through params_from_jax
    jcfg = j_reduced(j_get_arch(arch))
    jparams = JM.init_params(KEY, jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    want = dict(flatten(jax.tree.map(np.asarray, jparams)))
    got = dict(flatten(tparams))
    assert sorted(got) == sorted(want)
    new = {"router", "frame_adapter", "mask_emb", "patch_adapter"}
    assert any(new & set(path) for path in got)
    for path, w in want.items():
        t = got[path]
        if w.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=str(path))
        else:
            assert str(t.dtype) == f"torch.{w.dtype.name}", path
            np.testing.assert_array_equal(t.numpy(), w, err_msg=str(path))
    if jcfg.has_moe:
        assert tparams["stack"]["l0"]["ffn"]["router"].dtype == torch.float32

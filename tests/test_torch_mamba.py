"""The port's Mamba2 slice against the JAX reference: the SSD (K4's plain
version and the decode step), the mixer, prefill/decode, the serve loop and
a CPU grad step.

Inputs are made with numpy from a seed and handed to both packages; weights
come from the reference's init and cross over through ``params_from_jax``.
Config: reduced mamba2-130m (d_model 64, d_inner 128, 8 SSD heads × 16,
d_state 16, 1 group, conv 4, vocab 512). Tolerances: the reference's own SSD
kernel tolerances (tests/test_kernels.py:193), 5e-3 in f32 and 5e-2 in
bf16, for the SSD against its Pallas kernel in interpret mode (which
rounds its products differently) and its quadratic oracle; 1e-4 in f32 for
the mixer and the model, where only the summation order differs; 2e-2 of
the logit scale in bf16 (the reference's bf16 kernel tolerance, as in
tests/test_torch_serve.py); the reference's f32 ``GRAD_TOL`` 2e-4
(tests/test_kernel_grads.py:21) for the grad step.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.microbatch import dp_split, order_samples
from repro.core.shapes import ShapePalette
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_chunked as j_ssd_chunked
from repro.models import mamba as JMB
from repro.models import model as JM
from repro_torch import serve as SV
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

SSD_TOL = {"float32": 5e-3, "bfloat16": 5e-2}
F32_TOL = 1e-4
BF16_TOL = 2e-2
GRAD_TOL = 2e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", n_layers=2):
    j = dataclasses.replace(j_reduced(j_get_arch("mamba2-130m")),
                            n_layers=n_layers, dtype=dtype)
    t = dataclasses.replace(SV.make_config("mamba2-130m", "reduced", n_layers),
                            dtype=dtype)
    return j, t


def _ssd_inputs(b, t, h, p, g, n, seed=0, a_scale=1.0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, t, h)))).astype(np.float32)
    A = (-np.exp(r.standard_normal(h)) * a_scale).astype(np.float32)
    B = r.standard_normal((b, t, g, n)).astype(np.float32)
    C = r.standard_normal((b, t, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _both(arrays, dtype):
    """The SSD inputs for each package: x, B, C in ``dtype``, dt and A f32."""
    jd, td = DTYPES[dtype]
    x, dt, A, B, C = arrays
    j = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, jd), jnp.asarray(C, jd))
    t = (torch.from_numpy(x).to(td), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(B).to(td), torch.from_numpy(C).to(td))
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, tol, what=""):
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol, rtol=tol,
                               err_msg=what)


def _scaled_close(out, ref, tol, what):
    out, ref = _f32(out), _f32(ref)
    err = np.abs(out - ref).max() / (1.0 + np.abs(ref).max())
    assert err <= tol, f"{what}: scaled error {err:.3e} > {tol}"


# ----------------------------------------------------------------------
# the SSD
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,t,h,p,g,n,block", [
    (1, 64, 2, 16, 1, 16, 32),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 256, 2, 64, 1, 32, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssd_matches_reference_kernel_in_interpret_mode(
        b, t, h, p, g, n, block, dtype):
    (jx, jdt, jA, jB, jC), targs = _both(_ssd_inputs(b, t, h, p, g, n), dtype)
    yr, sr = j_ssd_chunked(jx, jdt, jA, jB, jC, block_t=block, interpret=True)
    tops.reset_launch_counts()
    y, st = tssd.ssd_chunked(*targs)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    assert tuple(y.shape) == (b, t, h, p) and tuple(st.shape) == (b, h, p, n)
    _close(y, yr, SSD_TOL[dtype], "y")
    _close(st, sr, SSD_TOL[dtype], "final state")
    assert tops.launch_counts()["ssd_chunked"] == 0     # CPU: plain version


@pytest.mark.parametrize("t,a_scale", [(1, 1.0), (96, 1.0), (192, 1.0),
                                       (200, 40.0)],
                         ids=["T1", "T96", "T192", "strong-decay"])
def test_plain_ssd_takes_ragged_lengths_and_strong_decay(t, a_scale):
    # T 96 is under the 128-step chunk, T 192 is what the reference's kernel
    # refuses (ssd.py:109); |A dt| of 40 per step sums past -60 in a chunk
    arrays = _ssd_inputs(2, t, 4, 16, 2, 16, seed=1, a_scale=a_scale)
    (jx, jdt, jA, jB, jC), targs = _both(arrays, "float32")
    yr, sr = jref.ssd_ref(jx, jdt, jA, jB, jC, return_state=True)
    y, st = tssd.ssd_chunked(*targs)
    _close(y, yr, SSD_TOL["float32"], "y")
    _close(st, sr, SSD_TOL["float32"], "final state")
    y2, st2 = tops.ssd(*targs, return_state=True)
    assert torch.equal(y2, y) and torch.equal(st2, st)
    # the quadratic oracle and the chunked plain version agree too
    yq, sq = tref.ssd_ref(*targs, return_state=True)
    _close(y, yq, SSD_TOL["float32"], "y vs the port's ssd_ref")
    _close(st, sq, SSD_TOL["float32"], "state vs the port's ssd_ref")


@pytest.mark.parametrize("b,t,h,p,g,n,block", [
    (1, 64, 2, 16, 1, 16, 32),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 256, 2, 64, 1, 32, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_parallel_form_matches_reference_kernel_in_interpret_mode(
        b, t, h, p, g, n, block, dtype):
    (jx, jdt, jA, jB, jC), targs = _both(_ssd_inputs(b, t, h, p, g, n), dtype)
    yr, sr = j_ssd_chunked(jx, jdt, jA, jB, jC, block_t=block, interpret=True)
    y, st, starts = tref.ssd_chunk_parallel(*targs)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    assert tuple(starts.shape) == (b, h, -(-t // 64) - 1, p, n)
    _close(y, yr, SSD_TOL[dtype], "y")
    _close(st, sr, SSD_TOL[dtype], "final state")


@pytest.mark.parametrize("t,g,a_scale", [(1, 2, 1.0), (96, 2, 1.0),
                                         (192, 1, 1.0), (300, 2, 1.0),
                                         (300, 4, 40.0)],
                         ids=["T1", "T96-groups", "T192", "T300-groups",
                              "strong-decay"])
def test_chunk_parallel_form_matches_the_chunked_plain_version(t, g, a_scale):
    # ragged T (the last 64-step chunk zero-filled), groups, and a decay
    # that sums past -60 within a chunk; each pass against the reference's
    # quadratic oracle too: the start states are its state after each
    # 64-step prefix
    arrays = _ssd_inputs(2, t, 4, 16, g, 16, seed=6, a_scale=a_scale)
    (jx, jdt, jA, jB, jC), targs = _both(arrays, "float32")
    y, st, starts = tref.ssd_chunk_parallel(*targs)
    y2, st2 = tref.ssd_ref_chunked(*targs)
    _close(y, y2, SSD_TOL["float32"], "y vs ssd_ref_chunked")
    _close(st, st2, SSD_TOL["float32"], "state vs ssd_ref_chunked")
    yr, sr = jref.ssd_ref(jx, jdt, jA, jB, jC, return_state=True)
    _close(y, yr, SSD_TOL["float32"], "y vs the reference's ssd_ref")
    _close(st, sr, SSD_TOL["float32"], "state vs the reference's ssd_ref")
    for c in range(starts.shape[2]):
        end = 64 * (c + 1)
        _, sc = jref.ssd_ref(jx[:, :end], jdt[:, :end], jA, jB[:, :end],
                             jC[:, :end], return_state=True)
        _close(starts[:, :, c], sc, SSD_TOL["float32"], f"start of chunk {c + 1}")


def test_ssd_with_an_initial_state_matches_reference_on_the_cpu():
    arrays = _ssd_inputs(1, 24, 2, 8, 1, 8, seed=2)
    (jx, jdt, jA, jB, jC), targs = _both(arrays, "float32")
    s0 = np.random.default_rng(3).standard_normal((1, 2, 8, 8)).astype(
        np.float32)
    yr, sr = jref.ssd_ref(jx, jdt, jA, jB, jC, initial_state=jnp.asarray(s0),
                          return_state=True)
    y, st = tops.ssd(*targs, initial_state=torch.from_numpy(s0),
                     return_state=True)
    _close(y, yr, F32_TOL)
    _close(st, sr, F32_TOL)


def test_ssd_decode_matches_reference_and_the_full_scan():
    b, t, h, p, g, n = 2, 16, 4, 8, 2, 8
    arrays = _ssd_inputs(b, t, h, p, g, n, seed=4)
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _both(arrays, "float32")
    s0 = np.random.default_rng(5).standard_normal((b, h, p, n)).astype(
        np.float32)
    yr, sr = jref.ssd_decode_ref(jx[:, 0], jdt[:, 0], jA, jB[:, 0], jC[:, 0],
                                 jnp.asarray(s0))
    y, st = tops.ssd_decode(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                            torch.from_numpy(s0))
    _close(y, yr, F32_TOL)
    _close(st, sr, F32_TOL)
    # T decode steps from a zero state give the full scan
    y_full, st_full = tssd.ssd_chunked(x, dt, A, B, C)
    state = torch.zeros((b, h, p, n))
    ys = []
    for i in range(t):
        yi, state = tops.ssd_decode(x[:, i], dt[:, i], A, B[:, i], C[:, i],
                                    state)
        ys.append(yi)
    _close(torch.stack(ys, dim=1), y_full, F32_TOL)
    _close(state, st_full, F32_TOL)


# ----------------------------------------------------------------------
# the mixer
# ----------------------------------------------------------------------
def _mixer_params(jcfg, seed=0):
    jp = JMB.init_mamba(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _cache_pair(jcfg, tcfg, b):
    jc = JM.T.init_cache(jcfg, b, 1, dtype=jnp.float32)[0]
    tc = TT.init_cache(tcfg, b, 1, dtype=torch.float32, device="cpu")[0]
    return ({k: v[0] for k, v in jc.items()}, {k: v[0] for k, v in tc.items()})


def test_mamba_mixer_train_prefill_and_decode_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _mixer_params(jcfg)
    r = np.random.default_rng(6)
    # train at T 64, a multiple of the reference kernel's block: interpret
    xs = r.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    jout, jnc = jax.jit(lambda p, x: JMB.mamba_fwd(
        p, x, jcfg, impl="interpret"))(jp, jnp.asarray(xs))
    tout, tnc = TMB.mamba_fwd(tp, torch.from_numpy(xs), tcfg)
    assert jnc is None and tnc is None
    _close(tout, jout, F32_TOL, "train")
    # prefill at T 40 (the reference's oracle), then 3 decode steps
    b, t = 3, 40
    xs = r.standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    jc, tc = _cache_pair(jcfg, tcfg, b)
    jout, jc = jax.jit(lambda p, x, c: JMB.mamba_fwd(
        p, x, jcfg, cache=c, mode="prefill", impl="ref"))(
        jp, jnp.asarray(xs), jc)
    tout, tc2 = TMB.mamba_fwd(tp, torch.from_numpy(xs), tcfg, cache=tc,
                              mode="prefill")
    assert tc2 is tc             # written in place
    _close(tout, jout, F32_TOL, "prefill")
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name], F32_TOL, f"prefill cache {name}")
    decode_j = jax.jit(lambda p, x, c: JMB.mamba_fwd(
        p, x, jcfg, cache=c, mode="decode"))
    for step in range(3):
        xd = r.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jout, jc = decode_j(jp, jnp.asarray(xd), jc)
        tout, tc = TMB.mamba_fwd(tp, torch.from_numpy(xd), tcfg, cache=tc,
                                 mode="decode")
        _close(tout, jout, F32_TOL, f"decode step {step}")
        for name in ("conv", "ssm"):
            _close(tc[name], jc[name], F32_TOL, f"decode {step} cache {name}")


def test_causal_conv_is_the_reference_conv_in_fp32():
    r = np.random.default_rng(7)
    u = r.standard_normal((2, 9, 12)).astype(np.float32)
    w = r.standard_normal((4, 12)).astype(np.float32)
    bias = r.standard_normal(12).astype(np.float32)
    ref = JMB._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(bias))
    out = TMB._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                           torch.from_numpy(bias))
    _close(out, ref, 1e-5)


# ----------------------------------------------------------------------
# params, the model, serving
# ----------------------------------------------------------------------
def test_init_params_and_params_from_jax_for_the_mamba_tree():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    conv = params_from_jax(jp, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    # embed, final_norm and the mixer's 8 leaves under ln1 (tied, no FFN)
    assert len(flat) == 11
    for path, leaf in flat:
        t, c = tp, conv
        for k in path:
            t, c = t[k.key], c[k.key]
        name = "/".join(str(k.key) for k in path)
        assert tuple(t.shape) == tuple(c.shape) == leaf.shape, name
        assert t.dtype == c.dtype, name
        if leaf.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(c.view(torch.int16).numpy(),
                                          leaf.view(np.int16))
        else:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(c.numpy(), leaf)
        lf, tf = leaf.astype(np.float32), t.float().numpy()
        if lf.std() == 0:          # zeros and ones are exact
            np.testing.assert_array_equal(tf, lf, err_msg=name)
        else:                      # same distribution: std within sampling
            np.testing.assert_allclose(tf.std(), lf.std(), rtol=0.1,
                                       err_msg=name)
    mixer = tp["stack"]["l0"]["mixer"]
    assert mixer["in_proj"].shape == (2, 64, 2 * 128 + 2 * 16 + 8)
    assert mixer["A_log"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(8)
    b, s, steps = 3, 24, 3
    tok = r.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[2, 17:], tok[2, 17:] = 0, 0          # a shorter prompt, padded
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    check = _close if dtype == "float32" else _scaled_close
    jlog, jc = JM.prefill(jp, {"tokens": jnp.asarray(tok),
                               "positions": jnp.asarray(pos)}, jcfg,
                          impl="ref", cache_len=s + steps)
    with torch.inference_mode():
        tlog, tc = TM.prefill(tp, {"tokens": torch.from_numpy(tok),
                                   "positions": torch.from_numpy(pos)}, tcfg,
                              cache_len=s + steps)
    assert tlog.dtype == torch.float32 and tlog.shape == (b, 512)
    assert tc[0]["ssm"].dtype == torch.float32
    assert tuple(tc[0]["conv"].shape) == (2, b, 3, 128 + 2 * 16)
    check(tlog, jlog, tol, "prefill logits")
    for name in ("conv", "ssm"):
        check(tc[0][name], jc[0][name], tol, f"prefill cache {name}")
    nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    for step in range(steps):
        p = np.full((b, 1), s + step, np.int32)
        jlog, jc = JM.decode(jp, {"tokens": jnp.asarray(nxt),
                                  "positions": jnp.asarray(p), "cache": jc,
                                  "cache_pos": jnp.asarray(s + step,
                                                           jnp.int32)},
                             jcfg, impl="ref")
        with torch.inference_mode():
            tlog, tc = TM.decode(tp, {"tokens": torch.from_numpy(nxt),
                                      "positions": torch.from_numpy(p),
                                      "cache": tc, "cache_pos": s + step},
                                 tcfg)
        check(tlog, jlog, tol, f"decode step {step} logits")
        for name in ("conv", "ssm"):
            check(tc[0][name], jc[0][name], tol, f"decode {step} cache {name}")
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)


def _example_prefill_cost():
    """examples/serve_batched.py's PrefillCost (its main() is not run)."""
    path = Path(__file__).resolve().parents[1] / "examples" / "serve_batched.py"
    spec = importlib.util.spec_from_file_location("serve_batched_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PrefillCost


def test_serve_loop_matches_reference_model_on_the_same_batches():
    jcfg, tcfg = _cfgs("float32")
    max_prompt, steps = SV.MAX_PROMPT, 2
    tokens = SV.make_requests(tcfg, SV.N_REQUESTS, max_prompt)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    res = SV.serve(tp, tcfg, tokens, max_prompt=max_prompt,
                   decode_steps=steps)
    # the reference example's planner gives the same batches
    lens = np.array([len(t) for t in tokens])
    pal = ShapePalette.build(min_seq=32, max_seq=max_prompt, seq_align=32,
                             max_mbs=16)
    order = order_samples(lens)
    jb = dp_split(lens[order], _example_prefill_cost()(jcfg, n_stages=1), 1,
                  palette=pal, mem_limit=1e12)
    np.testing.assert_array_equal(res.order, order)
    assert [(m.mbs, m.seq, tuple(m.indices)) for m in res.batches] == \
        [(m.mbs, m.seq, tuple(m.indices)) for m in jb]
    assert len(res.batches) > 1
    prefill_j = jax.jit(lambda p, b: JM.prefill(
        p, b, jcfg, cache_len=b["positions"].shape[1] + steps))
    decode_j = jax.jit(lambda p, b: JM.decode(p, b, jcfg))
    for mb, tlog, ttok in zip(res.batches, res.logits, res.tokens):
        tok, pos = SV.batch_arrays(mb, tokens, order)
        logits, cache = prefill_j(jp, {"tokens": jnp.asarray(tok),
                                       "positions": jnp.asarray(pos)})
        _close(tlog[0], logits, F32_TOL, "prefill logits")
        # the reference continues from the port's greedy tokens
        for step in range(steps):
            nxt = jnp.asarray(ttok[:, step:step + 1])
            np.testing.assert_array_equal(
                ttok[:, step], np.asarray(jnp.argmax(logits, -1)))
            logits, cache = decode_j(jp, {
                "tokens": nxt,
                "positions": jnp.full((mb.mbs, 1), mb.seq + step, jnp.int32),
                "cache": cache,
                "cache_pos": jnp.asarray(mb.seq + step, jnp.int32)})
            _close(tlog[step + 1], logits, F32_TOL, f"decode step {step}")


def test_serve_cli_runs_mamba_on_the_cpu():
    res = SV.main(["--arch", "mamba2-130m", "--width", "reduced",
                   "--device", "cpu", "--n-requests", "4",
                   "--decode-steps", "2"])
    assert res.decode_tokens == 8
    assert all(bool(torch.isfinite(x).all()) for x in res.logits)


# ----------------------------------------------------------------------
# a CPU grad step through the plain SSD
# ----------------------------------------------------------------------
def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_cpu_grad_step_matches_reference_value_and_grad():
    jcfg, tcfg = _cfgs("float32")
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg)
    # non-trivial A, dt bias and D, so their gradients are tested too
    r = np.random.default_rng(9)
    mixer = jp["stack"]["l0"]["mixer"]
    for name in ("A_log", "dt_bias", "D"):
        mixer[name] = jnp.asarray(
            r.standard_normal(mixer[name].shape).astype(np.float32) * 0.5)
    b, t = 2, 48
    tokens = r.integers(0, jcfg.vocab, (b, t)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    weights = np.ones((b, t), np.float32)
    weights[1, 30:] = 0.0
    batch = {"tokens": tokens, "labels": labels, "loss_weights": weights,
             "positions": np.broadcast_to(np.arange(t, dtype=np.int32),
                                          (b, t)).copy()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, bt: JM.loss_fn(p, bt, jcfg, impl="ref")[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names, leaves = zip(*_flat(tp))
    leaves = [x.requires_grad_() for x in leaves]
    tl, _ = TM.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                       tcfg)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    jgrads = dict(_flat(jg))
    assert sorted(jgrads) == sorted(names)
    for name, g in zip(names, grads):
        _close(g, jgrads[name], GRAD_TOL, f"grad {name}")

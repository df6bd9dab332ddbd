"""The port's layers against ``repro.models.layers`` on the same inputs.

Config: reduced gpt-paper (d 64, 4 heads, 2 KV heads, d_head 16, gelu,
non-gated MLP) at float32, so the comparison sees the algorithm and not
bf16 rounding. Tolerance 3e-5, the reference's f32 kernel tolerance
(tests/test_kernels.py:28): the two frameworks sum in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.models import layers as JL
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

TOL = 3e-5


def _cfgs(**kw):
    j = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")),
                            dtype="float32", **kw)
    t = dataclasses.replace(reduced(get_arch("gpt-paper")),
                            dtype="float32", **kw)
    return j, t


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(out, ref, tol=TOL, what=""):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def test_rms_norm_scales_by_one_plus_w_in_f32():
    x, w = _rand(0, 2, 5, 64, scale=3.0), _rand(1, 64, scale=0.1)
    ref = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), ref)
    # bf16 in: math in f32, cast back once
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    refb = JL.rms_norm(xb, jnp.asarray(w).astype(jnp.bfloat16), 1e-6)
    outb = TL.rms_norm(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                       .to(torch.bfloat16),
                       torch.from_numpy(np.array(jnp.asarray(w).astype(
                           jnp.bfloat16).astype(jnp.float32))).to(
                           torch.bfloat16), 1e-6)
    assert outb.dtype == torch.bfloat16
    _close(outb, refb.astype(jnp.float32), tol=2e-2)


def test_apply_rope_rotates_halves():
    x = _rand(2, 2, 7, 4, 16)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 3, 0, 40, 41, 1000, 7]],
                   np.int32)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    out = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(out, ref, tol=1e-4, what="rope (large angles: sin/cos of 1e3)")
    # interleaved pairs would be a different rotation
    half = torch.from_numpy(x)[..., 0::2]
    assert not torch.allclose(out[..., :8], half, atol=1e-3)


@pytest.mark.parametrize("name", ["gelu", "silu", "relu"])
def test_act_fn_matches_jax_nn(name):
    x = _rand(3, 4000, scale=3.0)
    ref = JL.act_fn(name)(jnp.asarray(x))
    _close(TL.act_fn(name)(torch.from_numpy(x)), ref)
    if name == "gelu":   # jax.nn.gelu is the tanh form; torch's default is not
        exact = F.gelu(torch.from_numpy(x))
        assert float((exact - torch.from_numpy(np.array(ref))).abs().max()) \
            > 1e-4


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_fwd(gated):
    jcfg, tcfg = _cfgs(mlp_gated=gated, act="silu" if gated else "gelu")
    p = JL.init_mlp(jax.random.PRNGKey(1), jcfg)
    x = _rand(4, 2, 6, 64)
    ref = JL.mlp_fwd(p, jnp.asarray(x), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    _close(TL.mlp_fwd(tp, torch.from_numpy(x), tcfg), ref)


def _attn_setup(seed=5, **kw):
    jcfg, tcfg = _cfgs(**kw)
    p = JL.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    return jcfg, tcfg, p, tp


def test_attention_fwd_train_mode_with_segments():
    jcfg, tcfg, p, tp = _attn_setup()
    b, t = 2, 24
    x = _rand(6, b, t, 64)
    seg = np.array([[0] * 10 + [1] * 10 + [-1] * 4, [3] * 24], np.int32)
    pos = np.array([list(range(10)) * 2 + [0] * 4, list(range(24))], np.int32)
    ref, _ = JL.attention_fwd(p, jnp.asarray(x), jcfg, local=False,
                              positions=jnp.asarray(pos),
                              segment_ids=jnp.asarray(seg), impl="ref")
    out, cache = TL.attention_fwd(tp, torch.from_numpy(x), tcfg, local=False,
                                  positions=torch.from_numpy(pos),
                                  segment_ids=torch.from_numpy(seg))
    assert cache is None
    _close(out, ref)


def _cache(b, s, kv=2, dh=16, seed=9):
    k, v = _rand(seed, b, s, kv, dh), _rand(seed + 1, b, s, kv, dh)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


@pytest.mark.parametrize("mode,t,cache_pos", [
    ("prefill", 12, 0), ("decode", 1, 12), ("decode", 1, 19)])
def test_attention_fwd_prefill_and_decode_write_cache(mode, t, cache_pos):
    jcfg, tcfg, p, tp = _attn_setup()
    b, s = 2, 20
    x = _rand(7, b, t, 64)
    pos = (np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)) if
           mode == "prefill" else np.full((b, 1), cache_pos, np.int32))
    jc, tc = _cache(b, s)
    ref, jnew = JL.attention_fwd(p, jnp.asarray(x), jcfg, local=False,
                                 positions=jnp.asarray(pos), segment_ids=None,
                                 cache=jc, cache_pos=jnp.asarray(cache_pos,
                                                                 jnp.int32),
                                 mode=mode, impl="ref")
    out, tnew = TL.attention_fwd(tp, torch.from_numpy(x), tcfg, local=False,
                                 positions=torch.from_numpy(np.array(pos)),
                                 segment_ids=None, cache=tc,
                                 cache_pos=cache_pos, mode=mode)
    _close(out, ref, what="attention out")
    for name in ("k", "v"):
        _close(tnew[name], jnew[name], what=f"cache {name}")
        assert tnew[name] is tc[name]      # written in place


@pytest.mark.parametrize("start", [0, 1, 5, 17, 18, 40])
def test_cache_write_clamps_like_dynamic_update_slice(start):
    s, t = 20, 3
    base = _rand(11, 2, s, 2, 4)
    new = _rand(12, 2, t, 2, 4)
    ref = jax.lax.dynamic_update_slice(jnp.asarray(base), jnp.asarray(new),
                                       (0, start, 0, 0))
    out = TL._write_cache(torch.from_numpy(base.copy()), torch.from_numpy(new),
                          start)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_masks_the_unwritten_cache_slots():
    # garbage beyond cache_pos must not change the decode output
    jcfg, tcfg, p, tp = _attn_setup()
    b, s, cache_pos = 2, 16, 6
    x = torch.from_numpy(_rand(13, b, 1, 64))
    pos = torch.full((b, 1), cache_pos, dtype=torch.int32)
    _, tc = _cache(b, s)
    tc2 = {k: v.clone() for k, v in tc.items()}
    tc2["k"][:, cache_pos + 1:] = 1e4
    tc2["v"][:, cache_pos + 1:] = -1e4
    kw = dict(local=False, positions=pos, segment_ids=None,
              cache_pos=cache_pos, mode="decode")
    a, _ = TL.attention_fwd(tp, x, tcfg, cache=tc, **kw)
    b2, _ = TL.attention_fwd(tp, x, tcfg, cache=tc2, **kw)
    torch.testing.assert_close(a, b2, atol=0, rtol=0)

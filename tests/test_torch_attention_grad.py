"""The port's attention backward (plain version of kernels K2 and K3)
against the JAX reference's Pallas backward run in interpret mode.

Inputs are made once from a numpy seed and handed to both packages. On the
CPU the port's ``mha_backward`` takes its plain version; the CUDA kernels
are held against that same plain version on the card by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.

Tolerances are the reference's own ``GRAD_TOL``
(tests/test_kernel_grads.py:21): 2e-4 in f32 and 4e-2 in bf16, applied as
that test applies them (``assert_allclose`` with atol = rtol).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

GRAD_TOL = {"float32": 2e-4, "bfloat16": 4e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CASES = {
    # name: (b, t, s, h, kv, d, opts, segmented); the reference tiles by 32
    "causal": (1, 64, 64, 2, 2, 16, dict(causal=True), False),
    "noncausal": (1, 64, 64, 2, 2, 16, dict(causal=False), False),
    "window": (1, 64, 64, 2, 2, 16, dict(causal=True, window=24), False),
    "softcap": (1, 64, 64, 2, 1, 16, dict(causal=True, softcap=2.0), False),
    "gqa": (1, 64, 64, 4, 1, 16, dict(causal=True), False),
    "segmented": (2, 64, 64, 2, 1, 16, dict(causal=True), True),
    "cross": (1, 32, 64, 2, 1, 16, dict(causal=False), False),
    # head dim 256 (gemma2-2b: GQA 2, softcap 50, a window on local layers)
    "d256_causal_gqa": (1, 64, 64, 2, 1, 256, dict(causal=True), False),
    "d256_window_softcap": (1, 64, 64, 2, 1, 256,
                            dict(causal=True, window=24, softcap=50.0), False),
    "d256_segmented": (2, 64, 64, 2, 1, 256, dict(causal=True), True),
}


def _both(x, dtype):
    """One numpy array as a jax array and a CPU torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])


def _ints(x):
    x = np.array(x, np.int32)     # a writable copy
    return jnp.asarray(x), torch.from_numpy(x)


def _segments(b, t):
    """Row 0: two samples then padding; row 1: one sample then padding, so
    its padded query rows see no key and its padded keys no query."""
    seg = np.full((b, t), -1, np.int32)
    pos = np.zeros((b, t), np.int32)
    a, c = t // 3, t // 3 + t // 4
    seg[0, :a], seg[0, a:c] = 0, 1
    pos[0, :a], pos[0, a:c] = np.arange(a), np.arange(c - a)
    seg[1, : t // 2] = 2
    pos[1, : t // 2] = np.arange(t // 2)
    return seg, pos


def _case(case, dtype):
    """q, k, v, the output cotangent, positions and segment ids of a case,
    each as a (jax, torch) pair."""
    b, t, s, h, kv, d, opts, segmented = CASES[case]
    r = np.random.default_rng(13)
    arrays = [r.standard_normal(shape, np.float32) for shape in
              ((b, t, h, d), (b, s, kv, d), (b, s, kv, d), (b, t, h, d))]
    q, k, v, ct = (_both(x, dtype) for x in arrays)
    qpos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    seg = (None, None)
    if segmented:
        sg, qpos = _segments(b, t)
        kpos = qpos
        seg = _ints(sg)
    return q, k, v, ct, _ints(qpos), _ints(kpos), seg, opts


def _close(out, ref, dtype, what):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=GRAD_TOL[dtype], rtol=GRAD_TOL[dtype],
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mha_backward_plain_matches_reference_backward(case, dtype):
    (jq, tq), (jk, tk), (jv, tv), (jct, tct), (jqp, tqp), (jkp, tkp), seg, \
        opts = _case(case, dtype)
    # residuals from the reference's oracle (its kernel agrees with it,
    # tests/test_kernels.py), jitted: one compilation instead of one per
    # op; the backward is the Pallas kernel's
    @jax.jit
    def residuals(q, k, v, qp, kp, sg):
        kw = dict(opts, q_positions=qp, kv_positions=kp, q_segment_ids=sg,
                  kv_segment_ids=sg)
        return jref.attention_ref(q, k, v, **kw), \
            jref.attention_ref_lse(q, k, **kw)
    jo, jl = residuals(jq, jk, jv, jqp, jkp, seg[0])
    ref = jfa.mha_backward(jq, jk, jv, jqp, jkp, seg[0], seg[0], jo, jl, jct,
                           **opts, block_q=32, block_kv=32, interpret=True)
    # the same residuals on the port's side
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(TORCH[dtype])
    tl = torch.from_numpy(np.array(jl))
    out = tfa.mha_backward(tq, tk, tv, tqp, tkp, seg[1], seg[1], to, tl, tct,
                           **opts)
    for name, a, r, x in zip(("dq", "dk", "dv"), out, ref, (tq, tk, tv)):
        assert a.dtype == x.dtype and a.shape == x.shape, name
        _close(a, r, dtype, f"{name} ({case}, {dtype})")
    if seg[1] is not None:     # rows and keys of padding take no gradient
        dead = seg[1] < 0
        assert (out[0][dead] == 0).all()
        assert (out[1][dead] == 0).all() and (out[2][dead] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["segmented", "softcap", "gqa", "cross"])
def test_autograd_through_ops_attention_matches_jax_grad(case, dtype):
    (jq, tq), (jk, tk), (jv, tv), (jct, tct), (jqp, tqp), (jkp, tkp), seg, \
        opts = _case(case, dtype)
    kw_j = dict(opts, q_positions=jqp, kv_positions=jkp,
                q_segment_ids=seg[0], kv_segment_ids=seg[0])

    def f(q, k, v):
        out = jops.attention(q, k, v, impl="interpret", block_q=32,
                             block_kv=32, **kw_j)
        return jnp.sum(out.astype(jnp.float32) * jct.astype(jnp.float32))
    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)

    tops.reset_launch_counts()
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tops.attention(*leaves, q_positions=tqp, kv_positions=tkp,
                         q_segment_ids=seg[1], kv_segment_ids=seg[1], **opts)
    (out.float() * tct.float()).sum().backward()
    for name, x, r in zip("qkv", leaves, ref):
        assert x.grad.dtype == x.dtype
        _close(x.grad, r, dtype, f"d{name} ({case}, {dtype})")
    # CPU tensors take the plain versions: no kernel was launched
    assert set(tops.launch_counts().values()) == {0}

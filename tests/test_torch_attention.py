"""The port's attention (plain version of kernel K1) against the JAX
reference's Pallas kernel run in interpret mode.

Inputs are made once from a numpy seed and handed to both packages. On the
CPU the port's ``mha_forward`` takes its plain version; the CUDA kernel is
held against that same plain version on the card by ``chip_smoke.py``.

Tolerances are the reference's own kernel-test ``TOL``
(tests/test_kernels.py:28): 3e-5 in f32 (summation order only) and 2e-2 in
bf16 (the two versions round to bf16 at different points).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ragged_attention as jra
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ragged_attention as tra
from repro_torch.kernels import ref as tref

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, b, t, s, h, kv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, t, h, d), np.float32),
            r.standard_normal((b, s, kv, d), np.float32),
            r.standard_normal((b, s, kv, d), np.float32))


def _both(x, dtype):
    """One numpy array as a jax array and a CPU torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])


def _ints(x):
    x = np.array(x, np.int32)     # a writable copy
    return jnp.asarray(x), torch.from_numpy(x)


def _segments(b, t):
    """Row 0: two samples then padding; row 1: one sample then padding,
    so its padded query rows see no key at all."""
    seg = np.full((b, t), -1, np.int32)
    pos = np.zeros((b, t), np.int32)
    a, c = t // 3, t // 3 + t // 4
    seg[0, :a], seg[0, a:c] = 0, 1
    pos[0, :a], pos[0, a:c] = np.arange(a), np.arange(c - a)
    seg[1, : t // 2] = 2
    pos[1, : t // 2] = np.arange(t // 2)
    return seg, pos


def _assert_close(out, ref, dtype, what):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype], err_msg=what)


CASES = {
    # name: (b, t, s, h, kv, d, opts, segmented); the reference tiles by 32
    # (shrunk to a divisor for T = 1 and T = 70), the port masks tails
    "causal": (2, 64, 64, 4, 4, 32, dict(causal=True), False),
    "noncausal": (2, 48, 80, 4, 4, 32, dict(causal=False), False),
    "window": (1, 128, 128, 2, 2, 32, dict(causal=True, window=24), False),
    "softcap": (1, 64, 64, 2, 1, 32, dict(causal=True, softcap=2.0), False),
    "gqa": (2, 64, 64, 8, 2, 16, dict(causal=True), False),
    "segmented": (2, 96, 96, 4, 2, 16, dict(causal=True), True),
    "segmented_noncausal": (2, 64, 64, 2, 2, 16, dict(causal=False), True),
    "decode_t1": (3, 1, 40, 4, 2, 32, dict(causal=True), False),
    "ragged_t70": (2, 70, 70, 2, 2, 32, dict(causal=True), False),
    # the serve's prefill into a longer cache: query positions 0..T-1, key
    # positions 0..S-1, the keys past the prompt masked by position
    "prefill_cache": (2, 48, 64, 4, 2, 32, dict(causal=True), False),
    # head dim 256 (gemma2-2b: GQA 2, softcap 50, a window on local layers)
    "d256_causal_gqa": (1, 64, 64, 2, 1, 256, dict(causal=True), False),
    "d256_window_softcap": (1, 128, 128, 2, 1, 256,
                            dict(causal=True, window=24, softcap=50.0), False),
    "d256_segmented": (2, 64, 64, 2, 1, 256, dict(causal=True), True),
    "d256_decode_t1": (3, 1, 40, 2, 1, 256, dict(causal=True, softcap=50.0),
                       False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mha_forward_matches_reference(case, dtype):
    b, t, s, h, kv, d, opts, segmented = CASES[case]
    q, k, v = _arrays(7, b, t, s, h, kv, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    if t == 1:   # decode: one new token per row at different cache fill
        qpos = np.array([[5], [17], [39]], np.int32)
        kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    else:
        qpos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
        kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    seg = (None, None)
    if segmented:
        sg, qpos = _segments(b, t)
        kpos = qpos
        seg = _ints(sg)
    (jqp, tqp), (jkp, tkp) = _ints(qpos), _ints(kpos)
    jo, jl = jfa.mha_forward(jq, jk, jv, jqp, jkp, seg[0], seg[0], **opts,
                             block_q=32, block_kv=32, interpret=True)
    to, tl = tfa.mha_forward(tq, tk, tv, tqp, tkp, seg[1], seg[1], **opts)
    assert to.dtype == TORCH[dtype] and tl.dtype == torch.float32
    assert to.shape == (b, t, h, d) and tl.shape == (b, h, t)
    _assert_close(to, jo, dtype, "o")
    _assert_close(tl, jl, dtype, "lse")
    if segmented:      # fully masked rows: o = 0, lse at the finite sentinel
        dead = torch.from_numpy(sg < 0)
        assert (to[dead] == 0).all()
        assert torch.isfinite(tl).all()
        assert (tl.permute(0, 2, 1)[dead] < -1e29).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("segmented", [False, True])
def test_oracles_match_reference_oracles(dtype, segmented):
    b, t, h, kv, d = 2, 48, 4, 2, 16
    q, k, v = _arrays(5, b, t, t, h, kv, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    kw_j, kw_t = dict(causal=True, window=20), dict(causal=True, window=20)
    if segmented:
        sg, pos = _segments(b, t)
        (js, ts), (jp, tp) = _ints(sg), _ints(pos)
        kw_j.update(q_positions=jp, kv_positions=jp, q_segment_ids=js,
                    kv_segment_ids=js)
        kw_t.update(q_positions=tp, kv_positions=tp, q_segment_ids=ts,
                    kv_segment_ids=ts)
    _assert_close(tref.attention_ref(tq, tk, tv, **kw_t),
                  jref.attention_ref(jq, jk, jv, **kw_j), dtype, "o")
    _assert_close(tref.attention_ref_lse(tq, tk, **kw_t),
                  jref.attention_ref_lse(jq, jk, **kw_j), dtype, "lse")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_attention_matches_reference(dtype):
    b, t, h, kv, d = 2, 96, 4, 2, 16
    q, k, v = _arrays(11, b, t, t, h, kv, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    sg, pos = _segments(b, t)
    (js, ts), (jp, tp) = _ints(sg), _ints(pos)
    ref = jra.ragged_attention(jq, jk, jv, js, js, causal=True, window=16,
                               q_positions=jp, kv_positions=jp, block_q=32,
                               block_kv=32, interpret=True)
    out = tra.ragged_attention(tq, tk, tv, ts, ts, causal=True, window=16,
                               q_positions=tp, kv_positions=tp)
    _assert_close(out, ref, dtype, "ragged o")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40), (False, 0)])
def test_live_block_mask_equals_reference(causal, window):
    b, t = 2, 256
    sg, pos = _segments(b, t)
    for segs in ((None, None), (sg, sg)):
        kw = dict(causal=causal, window=window, block_q=64, block_kv=32)
        ref = jfa.live_block_mask(pos, pos, *segs, **kw)
        out = tfa.live_block_mask(pos, pos, *segs, **kw)
        np.testing.assert_array_equal(out, ref)
    assert tfa.shrink_block(700, 512) == jfa.shrink_block(700, 512) == 4


def test_ops_attention_on_cpu_takes_plain_version_and_fills_one_side():
    tops.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _arrays(3, 2, 32, 48, 4, 2, 16))
    kv_seg = torch.zeros((2, 48), dtype=torch.int32)
    kv_seg[:, 40:] = -1
    out = tops.attention(q, k, v, causal=False, kv_segment_ids=kv_seg)
    ref = tfa.mha_forward_plain(
        q, k, v, torch.arange(32, dtype=torch.int32).expand(2, 32),
        torch.arange(48, dtype=torch.int32).expand(2, 48),
        torch.zeros((2, 32), dtype=torch.int32), kv_seg, causal=False)[0]
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    # the lone kv side masks the padded keys: changing them changes nothing
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 1e3
    v2[:, 40:] = -1e3
    out2 = tops.attention(q, k2, v2, causal=False, kv_segment_ids=kv_seg)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    assert tops.launch_counts() == {"mha_forward": 0, "mha_backward": 0,
                                    "ssd_chunked": 0, "ssd_backward": 0}
    assert _build._loaded == {}        # the CPU path never builds the kernel


def test_kernel_build_names_its_source_hash_and_needs_nvcc(monkeypatch):
    target = _build._target("flash_fwd")
    assert target.parent == _build.BUILD_DIR
    assert target.parent.parent.name == "build"    # listed in .gitignore
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    # checked before any build or launch, so these run without a card
    q = torch.zeros((1, 4, 2, 48), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 2, 48), dtype=torch.bfloat16)
    pos = torch.arange(4, dtype=torch.int32)[None]
    # a head dim between the instantiations reaches the kernel only padded
    # to the next one (48 -> 64, hubert's 80 -> 128, 136 -> 256); past 256
    # nothing takes it
    with pytest.raises(NotImplementedError, match="pad to kernel_head_dim"):
        tfa._check_cuda_args(q, k, k, (("q_positions", pos, 4),))
    assert [tfa.kernel_head_dim(d) for d in (8, 16, 48, 64, 80, 128, 136,
                                             200, 256)] == \
        [16, 16, 64, 64, 128, 128, 256, 256, 256]
    for d in (257, 512):
        with pytest.raises(NotImplementedError, match="at most 256"):
            tfa.kernel_head_dim(d)
    assert tfa.softmax_scale(80) == float(np.float32(1) / np.sqrt(
        np.float32(80)))
    padded = tfa.pad_head(q, 64)
    assert padded.shape == (1, 4, 2, 64) and not padded[..., 48:].any()
    assert tfa.pad_head(padded, 64) is padded
    (pq, pk), scale = tfa.kernel_operands(q, k)
    assert pq.shape == pk.shape == (1, 4, 2, 64) and not pk[..., 48:].any()
    assert scale == tfa.softmax_scale(48)
    q32 = torch.zeros((1, 4, 2, 128))
    with pytest.raises(TypeError, match="bf16"):
        tfa._check_cuda_args(q32, q32, q32, ())
    qb = torch.zeros((1, 4, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="both sides"):
        tfa._check_cuda_args(qb, qb, qb, (("q_segment_ids", pos, 4),
                                          ("kv_segment_ids", None, 4)))
    # the backward's residuals: do in bf16 like q, lse and delta (B,H,T) fp32
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="do must be"):
        tfa._check_bwd_args(qb, qb, lse, qb.float(), lse)
    with pytest.raises(ValueError, match="delta must be"):
        tfa._check_bwd_args(qb, qb, lse, qb, lse.transpose(1, 2))


# ----------------------------------------------------------------------
# the Python side of the fused backward kernel, without a card: the kernel
# adds ds k / sqrt(D) for each (query tile, key tile) pair into a zeroed
# fp32 accumulator (B, H, T rounded up to the query tile, D), in an order
# that zeroed int32 counters (B, H, query tiles) beside it fix, and the
# wrapper then casts it to dq (B, T, H, D) bf16
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,t,h,d", [
    (2, 64, 4, 16),       # T a multiple of the query tile
    (1, 100, 3, 32),      # ragged: 28 padded rows dropped
    (2, 1, 2, 64),        # one row
    (1, 130, 2, 128),
])
def test_dq_accumulator_shape_and_cast(b, t, h, d):
    q = torch.zeros((b, t, h, d), dtype=torch.bfloat16)
    acc, sem = tfa.dq_accumulator(q)
    t_pad = -(-t // tfa.BWD_QTILE) * tfa.BWD_QTILE
    assert acc.shape == (b, h, t_pad, d) and acc.dtype == torch.float32
    assert acc.is_contiguous() and not acc.any()
    # one query tile is one contiguous block of the accumulator
    assert acc.stride(2) == d and acc.stride(1) == t_pad * d
    # one zeroed counter per query tile, from the same allocation
    assert sem.shape == (b, h, t_pad // tfa.BWD_QTILE)
    assert sem.dtype == torch.int32 and sem.is_contiguous() and not sem.any()
    assert sem.untyped_storage().data_ptr() == acc.untyped_storage().data_ptr()
    rng = np.random.default_rng(0)
    acc = torch.from_numpy(rng.standard_normal(acc.shape).astype(np.float32))
    dq = tfa.dq_from_accumulator(acc, t)
    assert dq.shape == (b, t, h, d) and dq.dtype == torch.bfloat16
    assert dq.is_contiguous()
    direct = np.transpose(acc.numpy()[:, :, :t], (0, 2, 1, 3))
    want = torch.from_numpy(np.ascontiguousarray(direct)).to(torch.bfloat16)
    assert torch.equal(dq, want)


def _residuals(d, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    b, t, h = 1, 8, 2
    q, k, v, o, do = (torch.randn((b, t, h, d), generator=g).to(dtype)
                      for _ in range(5))
    pos = torch.arange(t, dtype=torch.int32)[None]
    lse = torch.zeros((b, h, t), dtype=torch.float32)
    return q, k, v, pos, pos, None, None, o, lse, do


def test_backward_cuda_refuses_a_cpu_tensor():
    args = _residuals(64)
    before = dict(tfa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.mha_backward_cuda(*args, tfa.attention_delta(args[7], args[9]),
                              causal=True, window=0, softcap=None)
    assert tfa.LAUNCHES == before
    assert "flash_bwd" not in _build._loaded


def test_backward_cuda_args_refuse_an_unsupported_head_dim():
    # 48 is no instantiation (the wrapper pads it to 64); past 256 nothing
    # takes a head dim, padded or not
    for d in (48, 264):
        args = _residuals(d)
        delta = tfa.attention_delta(args[7], args[9])
        with pytest.raises(NotImplementedError, match="instantiated at head "
                           r"dims \(16, 32, 64, 128, 256\)"):
            tfa.check_backward_cuda_args(*args, delta)
        with pytest.raises(ValueError):
            tfa.mha_backward_cuda(*args, delta, causal=True, window=0,
                                  softcap=None)
    with pytest.raises(NotImplementedError, match="at most 256"):
        tfa.kernel_operands(*_residuals(264)[:3])


def test_backward_cuda_args_refuse_more_keys_than_the_kernel_takes():
    # the kernel's table of key-tile statistics holds BWD_MAX_KEYS keys
    q, k, v, qp, kp, qs, ks, o, lse, do = _residuals(16)
    delta = tfa.attention_delta(o, do)
    for s, ok in ((tfa.BWD_MAX_KEYS, True), (tfa.BWD_MAX_KEYS + 1, False)):
        kl = torch.zeros((1, s, 2, 16), dtype=torch.bfloat16)
        kpl = torch.arange(s, dtype=torch.int32)[None]
        args = (q, kl, kl.clone(), qp, kpl, qs, ks, o, lse, do, delta)
        if ok:
            tfa.check_backward_cuda_args(*args)
        else:
            with pytest.raises(ValueError, match="at most 65536 keys"):
                tfa.check_backward_cuda_args(*args)
    assert "flash_bwd" not in _build._loaded


@pytest.mark.parametrize("acc_dtype,acc_heads", [
    (torch.bfloat16, 2),   # not fp32
    (torch.float32, 3),    # (B, H, T_pad, D) with the wrong H
])
def test_backward_launch_refuses_a_bad_accumulator(acc_dtype, acc_heads):
    # checked before the kernel is built, so this runs without a card
    args = _residuals(64)
    q, k = args[0], args[1]
    delta = tfa.attention_delta(args[7], args[9])
    acc = torch.zeros((1, acc_heads, tfa.BWD_QTILE, 64), dtype=acc_dtype)
    with pytest.raises(ValueError, match="dq accumulator"):
        tfa._launch_backward(*args, delta, acc, torch.empty_like(k),
                             torch.empty_like(k), causal=True, window=0,
                             softcap=None, sm_scale=tfa.softmax_scale(64))
    assert "flash_bwd" not in _build._loaded


def test_backward_on_the_cpu_takes_the_plain_version():
    q, k, v, qp, kp, qs, ks, o, lse, do = _residuals(16)
    before = dict(tfa.LAUNCHES)
    out = tfa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do, causal=True)
    ref = tfa.mha_backward_plain(q, k, v, qp, kp, qs, ks, o, lse, do,
                                 causal=True)
    for a, r in zip(out, ref):
        assert torch.equal(a, r)
    assert tfa.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_leaves_its_residuals_unchanged(dtype):
    args = _residuals(16, TORCH[dtype])
    o, do = args[7], args[9]
    kept = [x.clone() for x in (o, do)]
    delta = tfa.attention_delta(o, do)
    first = tfa.mha_backward(*args, causal=True)
    assert torch.equal(o, kept[0]) and torch.equal(do, kept[1])
    # a second backward from the same residuals sees the same delta
    torch.testing.assert_close(tfa.attention_delta(o, do), delta,
                               atol=0, rtol=0)
    for a, r in zip(tfa.mha_backward(*args, causal=True), first):
        assert torch.equal(a, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_grad_twice_from_one_graph(dtype):
    # the saved o is the tensor forward returned: the backward must neither
    # write it nor trip autograd's saved-tensor version check
    q, k, v = (torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
               for x in _arrays(4, 1, 16, 16, 4, 2, 16))
    out = tfa.flash_attention(q, k, v, causal=True)
    kept = out.detach().clone()
    do = torch.from_numpy(
        np.random.default_rng(5).standard_normal(out.shape, np.float32)
    ).to(out.dtype)
    first = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    second = torch.autograd.grad(out, (q, k, v), do)
    assert torch.equal(out.detach(), kept)
    for a, r in zip(second, first):
        assert torch.equal(a, r)

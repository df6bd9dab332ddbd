"""Attention forward and backward: the CUDA kernels K1, K2 and K3 and their
plain PyTorch versions.

Counterpart of ``repro.kernels.flash_attention``. :func:`mha_forward` and
:func:`mha_backward` take the path their tensors' device gives: on a CUDA
tensor they launch the hand-written Hopper kernels (K1 in
``csrc/flash_fwd.cu``; K2, the dq pass, and K3, the dk/dv pass, in
``csrc/flash_bwd.cu``) or raise, on a CPU tensor they run
:func:`mha_forward_plain` and :func:`mha_backward_plain`, which materialise
the whole score matrix. There is no fallback from one to the other.

The numpy helpers ``shrink_block``, ``_live_terms`` and ``live_block_mask``
are copied verbatim: the kernel evaluates the same skip predicate per tile.
It masks ragged tails instead of shrinking its tiles, so ``shrink_block``
stays only for ``live_block_mask``.

:class:`Attention` is the ``torch.autograd.Function`` of the reference's
``_flash`` and ``_ragged`` custom VJPs: its forward saves the residuals
``(q, k, v, positions, segment ids, o, lse)`` and its backward runs
:func:`mha_backward` on them, so a gradient through a CUDA tensor goes
through K2 and K3.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ref as _ref

NEG_INF = -1e30

HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations

# Launches of each CUDA kernel, counted where the wrapper launches it:
# K1, K2 and K3.
LAUNCHES = {"mha_forward": 0, "mha_backward_dq": 0, "mha_backward_dkv": 0}


def shrink_block(length: int, block: int) -> int:
    """Largest divisor of ``length`` that also divides ``block``.

    Blocks must tile the sequence exactly. When a bucketed length is not a
    multiple of the requested block (e.g. palette bucket 768 with block
    512), shrink to the gcd so alignment factors (128/64/32 buckets)
    survive instead of asserting.
    """
    block = min(block, length)
    if length % block:
        block = math.gcd(length, block)
    return block


# ----------------------------------------------------------------------
# block-level liveness (shared by kernels, benches, and tests)
# ----------------------------------------------------------------------
def _live_terms(qpos, kpos, qseg, kseg, causal, window):
    """The block-skip predicate from per-block min/max statistics.

    Works on traced scalars inside the kernels and on numpy arrays in
    :func:`live_block_mask`; `qpos`/`kpos` etc. are (min, max) pairs.
    """
    (q_pmin, q_pmax), (k_pmin, k_pmax) = qpos, kpos
    live = True
    if qseg is not None:
        (q_smin, q_smax), (k_smin, k_smax) = qseg, kseg
        live = (q_smax >= k_smin) & (k_smax >= q_smin) \
            & (k_smax >= 0) & (q_smax >= 0)
    if causal:
        live &= q_pmax >= k_pmin
        if window > 0:
            live &= (q_pmin - k_pmax) < window
    return live


def live_block_mask(q_positions, kv_positions,
                    q_segment_ids=None, kv_segment_ids=None, *,
                    causal: bool = True, window: int = 0,
                    block_q: int, block_kv: int) -> np.ndarray:
    """(B, nq, nk) bool: which (q-block, kv-block) pairs the kernels visit.

    This is the exact predicate the forward, dq, and dk/dv kernels gate
    compute on, evaluated in numpy — deterministic and machine-independent,
    so benchmarks can report the *live-block fraction* (the share of the
    quadratic block grid that reaches the MXU) without running a TPU.
    """
    qp = np.asarray(q_positions)
    kp = np.asarray(kv_positions)
    b, t = qp.shape
    s = kp.shape[1]
    block_q = shrink_block(t, block_q)
    block_kv = shrink_block(s, block_kv)
    nq, nk = t // block_q, s // block_kv

    def mm(x, n, blk):   # (B, n, 1) min / max per block
        xb = np.asarray(x).reshape(b, n, blk)
        return xb.min(axis=2), xb.max(axis=2)

    q_pmin, q_pmax = mm(qp, nq, block_q)
    k_pmin, k_pmax = mm(kp, nk, block_kv)
    qseg = kseg = None
    if q_segment_ids is not None:
        qs_min, qs_max = mm(q_segment_ids, nq, block_q)
        ks_min, ks_max = mm(kv_segment_ids, nk, block_kv)
        qseg = (qs_min[:, :, None], qs_max[:, :, None])
        kseg = (ks_min[:, None, :], ks_max[:, None, :])
    live = _live_terms(
        (q_pmin[:, :, None], q_pmax[:, :, None]),
        (k_pmin[:, None, :], k_pmax[:, None, :]),
        qseg, kseg, causal, window)
    return np.broadcast_to(np.asarray(live), (b, nq, nk))


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def mha_forward_plain(q, k, v, q_positions, kv_positions,
                      q_segment_ids=None, kv_segment_ids=None, *,
                      causal, window=0, softcap=None):
    """K1's function in plain PyTorch: ``(o, lse)``, lse (B,H,T) fp32."""
    return _ref.attention_ref_with_lse(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_positions=q_positions, kv_positions=kv_positions,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)


def _element_mask(qpos, kpos, qseg, kseg, causal, window):
    """The reference's ``_element_mask`` over whole rows: (B, 1, T, S) bool,
    or None where every pair is visible."""
    mask = None
    if qseg is not None:
        mask = (qseg[:, :, None] == kseg[:, None, :]) & (kseg[:, None, :] >= 0)
    if causal:
        dpos = qpos[:, :, None].long() - kpos[:, None, :].long()
        cm = dpos >= 0
        if window > 0:
            cm &= dpos < window
        mask = cm if mask is None else (mask & cm)
    return None if mask is None else mask[:, None]


def attention_delta(o, do):
    """delta = rowsum(do * o), (B,H,T) fp32: the reduction the reference
    takes outside its kernels (``flash_attention.py:392``)."""
    return torch.einsum("bthd,bthd->bht", do.float(), o.float()).contiguous()


def mha_backward_plain(q, k, v, q_positions, kv_positions,
                       q_segment_ids, kv_segment_ids, o, lse, do, *,
                       causal, window=0, softcap=None):
    """K2's and K3's function in plain PyTorch, from the same residuals:
    ``(dq, dk, dv)`` in the inputs' dtypes. Follows the reference's
    ``_p_and_ds`` in fp32 over the whole (T, S) score matrix: p from lse,
    masked by select, dp = do v^T, ds = p (dp - delta) with the softcap
    ``1 - tanh^2`` chain; dk and dv summed over each GQA head group."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf = _ref._repeat_kv(k, group).float()
    vf = _ref._repeat_kv(v, group).float()
    s1 = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    th = None
    if softcap is not None:
        th = torch.tanh(s1 / softcap)
        s1 = softcap * th
    p = torch.exp(s1 - lse[..., None])
    del s1
    mask = _element_mask(q_positions, kv_positions, q_segment_ids,
                         kv_segment_ids, causal, window)
    if mask is not None:
        # also zeroes fully masked rows, whose lse is the -1e30 sentinel
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - attention_delta(o, do)[..., None])
    del dp
    if th is not None:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, dof)

    def per_kv_head(x):   # (B,S,H,D) -> sum over each group -> (B,S,KV,D)
        return x.reshape(b, s, kvh, group, d).sum(3)
    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


# ----------------------------------------------------------------------
# the kernels' wrappers
# ----------------------------------------------------------------------
def _check_cuda_args(q, k, v, ints):
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, got {d}")
    if k.shape != (b, s, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16; {name} is {x.dtype}")
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")
    named = {name: x for name, x, _ in ints}
    if ("q_segment_ids" in named
            and (named["q_segment_ids"] is None)
            != (named["kv_segment_ids"] is None)):
        raise ValueError("segment ids must be given on both sides or neither")
    for name, x, n in ints:
        if x is None:
            continue
        if (x.dtype != torch.int32 or x.shape != (b, n) or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {(b, n)} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)}")


def _int_args(q, k, q_positions, kv_positions, q_segment_ids, kv_segment_ids):
    t, s = q.shape[1], k.shape[1]
    return (("q_positions", q_positions, t), ("kv_positions", kv_positions, s),
            ("q_segment_ids", q_segment_ids, t),
            ("kv_segment_ids", kv_segment_ids, s))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _mha_forward_cuda(q, k, v, q_positions, kv_positions,
                      q_segment_ids, kv_segment_ids, *,
                      causal, window, softcap):
    from repro_torch.kernels import _build
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    _check_cuda_args(q, k, v, _int_args(q, k, q_positions, kv_positions,
                                        q_segment_ids, kv_segment_ids))
    lib = _build.library("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _build.launch(lib.mha_fwd_bf16,
            _ptr(q), _ptr(k), _ptr(v), _ptr(q_positions), _ptr(kv_positions),
            _ptr(q_segment_ids), _ptr(kv_segment_ids), _ptr(o), _ptr(lse),
            b, t, s, h, kvh, d, int(causal), int(window),
            float(softcap or 0.0), device=q.device)
    LAUNCHES["mha_forward"] += 1
    return o, lse


def _check_bwd_args(q, o, lse, do, delta):
    b, t, h, _ = q.shape
    for name, x in (("o", o), ("do", do)):
        if (x.dtype != torch.bfloat16 or x.shape != q.shape
                or x.device != q.device or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous bf16 {tuple(q.shape)} "
                             f"tensor on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or x.shape != (b, h, t)
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 {(b, h, t)} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)}")


def check_backward_cuda_args(q, k, v, q_positions, kv_positions,
                             q_segment_ids, kv_segment_ids, o, lse, do, delta):
    """Everything K2 and K3 assume of their arguments: device, dtype,
    shape, alignment and contiguity. Raises on the first that fails."""
    _check_cuda_args(q, k, v, _int_args(q, k, q_positions, kv_positions,
                                        q_segment_ids, kv_segment_ids))
    _check_bwd_args(q, o, lse, do, delta)


def _launch_dq(q, k, v, q_positions, kv_positions, q_segment_ids,
               kv_segment_ids, o, lse, do, delta, *, causal, window, softcap):
    from repro_torch.kernels import _build
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    _build.launch(_build.library("flash_bwd").mha_bwd_dq_bf16,
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(q_positions), _ptr(kv_positions), _ptr(q_segment_ids),
            _ptr(kv_segment_ids), _ptr(dq), b, t, s, h, kvh, d, int(causal),
            int(window), float(softcap or 0.0), device=q.device)
    LAUNCHES["mha_backward_dq"] += 1
    return dq


def _launch_dkv(q, k, v, q_positions, kv_positions, q_segment_ids,
                kv_segment_ids, o, lse, do, delta, *, causal, window, softcap):
    from repro_torch.kernels import _build
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(_build.library("flash_bwd").mha_bwd_dkv_bf16,
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(q_positions), _ptr(kv_positions), _ptr(q_segment_ids),
            _ptr(kv_segment_ids), _ptr(dk), _ptr(dv), b, t, s, h, kvh, d,
            int(causal), int(window), float(softcap or 0.0), device=q.device)
    LAUNCHES["mha_backward_dkv"] += 1
    return dk, dv


def mha_backward_dq_cuda(*args, **opts):
    """Check the arguments, then launch K2: dq (B,T,H,D) bf16. Arguments as
    :func:`mha_backward`, plus ``delta`` from :func:`attention_delta`."""
    check_backward_cuda_args(*args)
    return _launch_dq(*args, **opts)


def mha_backward_dkv_cuda(*args, **opts):
    """Check the arguments, then launch K3: ``(dk, dv)``, (B,S,KV,D) bf16
    each, summed over each GQA group. Arguments as
    :func:`mha_backward_dq_cuda`."""
    check_backward_cuda_args(*args)
    return _launch_dkv(*args, **opts)


def _check_softcap(softcap):
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")


def mha_forward(q, k, v, q_positions, kv_positions,
                q_segment_ids=None, kv_segment_ids=None, *,
                causal, window=0, softcap=None):
    """Raw forward: returns ``(o, lse)`` with lse in (B, H, T) fp32.

    q (B,T,H,D), k/v (B,S,KV,D) with H % KV == 0; positions and segment ids
    (B,T)/(B,S) int32, segment ids -1 on padding. CUDA tensors launch K1
    (bf16, D in ``HEAD_DIMS``, contiguous); CPU tensors take the plain
    version.
    """
    _check_softcap(softcap)
    if q.device.type == "cuda":
        return _mha_forward_cuda(
            q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
            causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return mha_forward_plain(
            q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
            causal=causal, window=window, softcap=softcap)
    raise ValueError(f"no attention path for device {q.device}")


def mha_backward(q, k, v, q_positions, kv_positions, q_segment_ids,
                 kv_segment_ids, o, lse, do, *, causal, window=0,
                 softcap=None):
    """Backward from the forward's residuals: returns ``(dq, dk, dv)``.

    CUDA tensors launch K2 (dq) and K3 (dk, dv) after the plain reduction
    ``delta = rowsum(do * o)``; CPU tensors take
    :func:`mha_backward_plain`.
    """
    _check_softcap(softcap)
    args = (q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, o, lse, do)
    opts = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cuda":
        delta = attention_delta(o, do)
        check_backward_cuda_args(*args, delta)
        dq = _launch_dq(*args, delta, **opts)
        return (dq, *_launch_dkv(*args, delta, **opts))
    if q.device.type == "cpu":
        return mha_backward_plain(*args, **opts)
    raise ValueError(f"no attention path for device {q.device}")


class Attention(torch.autograd.Function):
    """Attention with its gradient, the counterpart of the reference's
    ``_flash`` and ``_ragged`` custom VJPs (segment ids None for the
    former). Positions and segment ids take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, q_segment_ids,
                kv_segment_ids, causal, window, softcap):
        o, lse = mha_forward(q, k, v, q_positions, kv_positions,
                             q_segment_ids, kv_segment_ids, causal=causal,
                             window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions,
                              q_segment_ids, kv_segment_ids, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = mha_backward(*ctx.saved_tensors, do.contiguous(),
                                  **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None


def _default_positions(x, n):
    return torch.arange(n, dtype=torch.int32, device=x.device)[None].expand(
        x.shape[0], n).contiguous()


def attention(q, k, v, q_positions=None, kv_positions=None,
              q_segment_ids=None, kv_segment_ids=None, *, causal=True,
              window=0, softcap=None):
    """The shared body of :func:`flash_attention` and ``ragged_attention``:
    default positions, int32 and contiguous inputs, then :class:`Attention`."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    assert k.shape == (b, s, kvh, d) and v.shape == (b, s, kvh, d)
    assert h % kvh == 0, (h, kvh)
    if q_positions is None:
        q_positions = _default_positions(q, t)
    if kv_positions is None:
        kv_positions = _default_positions(k, s)

    def i32(x):
        return None if x is None else x.to(torch.int32).contiguous()

    return Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           i32(q_positions), i32(kv_positions),
                           i32(q_segment_ids), i32(kv_segment_ids),
                           causal, int(window), softcap)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=None,
                    q_positions=None, kv_positions=None):
    """Attention without segment ids: (B,T,H,D) in q.dtype."""
    return attention(q, k, v, q_positions, kv_positions, causal=causal,
                     window=window, softcap=softcap)

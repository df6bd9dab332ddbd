"""Attention forward: the CUDA kernel K1 and its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention``. :func:`mha_forward` takes
the path its tensors' device gives: on a CUDA tensor it launches the
hand-written Hopper kernel in ``csrc/flash_fwd.cu`` (or raises), on a CPU
tensor it runs :func:`mha_forward_plain`, the materialised-scores oracle.
There is no fallback from one to the other.

The numpy helpers ``shrink_block``, ``_live_terms`` and ``live_block_mask``
are copied verbatim: the kernel evaluates the same skip predicate per tile.
It masks ragged tails instead of shrinking its tiles, so ``shrink_block``
stays only for ``live_block_mask``.

The kernel has no backward yet; a gradient through it raises. Serving runs
under ``torch.inference_mode()``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ref as _ref

NEG_INF = -1e30

HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations

# Launches of each CUDA kernel, counted where the wrapper launches it.
LAUNCHES = {"mha_forward": 0}


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
# the kernel's wrapper and its plain version
# ----------------------------------------------------------------------
def mha_forward_plain(q, k, v, q_positions, kv_positions,
                      q_segment_ids=None, kv_segment_ids=None, *,
                      causal, window=0, softcap=None):
    """The kernel's function in plain PyTorch: ``(o, lse)``, lse (B,H,T) fp32."""
    return _ref.attention_ref_with_lse(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_positions=q_positions, kv_positions=kv_positions,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)


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
    for name, x, n in ints:
        if x is None:
            continue
        if (x.dtype != torch.int32 or x.shape != (b, n) or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {(b, n)} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)}")
    if any(x.requires_grad for x in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "the CUDA attention kernel has no backward yet; run it under "
            "torch.inference_mode()")


def _mha_forward_cuda(q, k, v, q_positions, kv_positions,
                      q_segment_ids, kv_segment_ids, *,
                      causal, window, softcap):
    from repro_torch.kernels import _build
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    _check_cuda_args(q, k, v, (
        ("q_positions", q_positions, t), ("kv_positions", kv_positions, s),
        ("q_segment_ids", q_segment_ids, t),
        ("kv_segment_ids", kv_segment_ids, s)))
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment ids must be given on both sides or neither")
    lib = _build.library("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mha_fwd_bf16(
            ptr(q), ptr(k), ptr(v), ptr(q_positions), ptr(kv_positions),
            ptr(q_segment_ids), ptr(kv_segment_ids), ptr(o), ptr(lse),
            b, t, s, h, kvh, d, int(causal), int(window),
            float(softcap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"mha_fwd_bf16 launch failed: CUDA error {rc}")
    LAUNCHES["mha_forward"] += 1
    return o, lse


def mha_forward(q, k, v, q_positions, kv_positions,
                q_segment_ids=None, kv_segment_ids=None, *,
                causal, window=0, softcap=None):
    """Raw forward: returns ``(o, lse)`` with lse in (B, H, T) fp32.

    q (B,T,H,D), k/v (B,S,KV,D) with H % KV == 0; positions and segment ids
    (B,T)/(B,S) int32, segment ids -1 on padding. CUDA tensors launch the
    kernel (bf16, D in ``HEAD_DIMS``, contiguous); CPU tensors take the plain
    version.
    """
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    if q.device.type == "cuda":
        return _mha_forward_cuda(
            q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
            causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return mha_forward_plain(
            q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
            causal=causal, window=window, softcap=softcap)
    raise ValueError(f"no attention path for device {q.device}")


def _default_positions(x, n):
    return torch.arange(n, dtype=torch.int32, device=x.device)[None].expand(
        x.shape[0], n).contiguous()


def flash_attention(q, k, v, *, causal=True, window=0, softcap=None,
                    q_positions=None, kv_positions=None):
    """Attention without segment ids: (B,T,H,D) in q.dtype."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    assert k.shape == (b, s, kvh, d) and v.shape == (b, s, kvh, d)
    assert h % kvh == 0, (h, kvh)
    if q_positions is None:
        q_positions = _default_positions(q, t)
    if kv_positions is None:
        kv_positions = _default_positions(k, s)
    o, _ = mha_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                       q_positions.to(torch.int32).contiguous(),
                       kv_positions.to(torch.int32).contiguous(),
                       causal=causal, window=int(window), softcap=softcap)
    return o

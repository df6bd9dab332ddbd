"""Attention forward and backward: the CUDA kernels and their plain
PyTorch versions.

Counterpart of ``repro.kernels.flash_attention``. :func:`mha_forward` and
:func:`mha_backward` take the path their tensors' device gives: on a CUDA
tensor they launch the hand-written Hopper kernels or raise, on a CPU
tensor they run :func:`mha_forward_plain` and :func:`mha_backward_plain`,
which materialise the whole score matrix. There is no fallback from one to
the other. On a ``meta`` tensor (asked for by a dry run, ``launch/
dryrun.py``) the kernel wrappers make the allocations the CUDA path makes
and return empty outputs of the kernels' shapes, launching nothing. Each
wrapper charges its kernel to the open ``launch/op_cost.py`` counters by
formula (:func:`attention_cost`), on the card and on ``meta`` alike.

- K1, the forward, is ``csrc/flash_fwd.cu``. For T ≤ ``DECODE_MAX_T`` it
  takes its decode form: one block per (cache split, KV head, batch row)
  over the GQA group's rows. :func:`decode_plan` picks the number of
  splits on the host from the shapes and the SM count; with more than one,
  the wrapper allocates a zeroed fp32 workspace for the splits' partial
  ``(acc, m, l)`` and int32 counters, by which the last block of each
  group merges them in ascending split order.
  :func:`decode_live_tiles`, :func:`decode_split_tiles`,
  :func:`decode_partial_plain` and :func:`decode_merge_plain` are that
  split and merge in plain PyTorch, for the tests.
- The backward is one kernel in ``csrc/flash_bwd.cu``. It replaces both of
  the reference's backward passes: K2 (dq) and K3 (dk, dv). One launch
  computes dq, dk and dv in a single pass over the live (query tile, key
  tile) pairs. dk and dv are summed in registers and stored once. dq is
  summed across key tiles into a zeroed fp32 scratch (B, H, T rounded up
  to ``BWD_QTILE``, D) by reduce-adds in a fixed order, ascending key tile
  per (batch row, head, query tile), which int32 counters beside the
  scratch enforce (:func:`dq_accumulator`); so the backward is repeatable
  bit for bit. :func:`dq_from_accumulator` then casts dq to bf16
  (B, T, H, D).

The kernels are instantiated at head dims ``HEAD_DIMS``. A head dim
between two of them (hubert's 80, or anything from 129 to 255) is
zero-padded by the wrappers to the next one up and cut back after the
launch: zero columns add nothing to q kᵀ or to ds·k, and their outputs are
zero, so the result is exact; the softmax scale stays 1/√(the caller's head
dim). At head dim 256 (gemma2-2b) K1's prefill takes 64-key tiles, and the
backward has a wgmma form of its own that splits each item's products
between its two consumer warpgroups, because the D ≤ 128 plans do not fit
in shared memory and registers there. A head dim past 256 raises.

The numpy helpers ``shrink_block``, ``_live_terms`` and ``live_block_mask``
are copied verbatim: the kernel evaluates the same skip predicate per tile.
It masks ragged tails instead of shrinking its tiles, so ``shrink_block``
stays only for ``live_block_mask``.

:class:`Attention` is the ``torch.autograd.Function`` of the reference's
``_flash`` and ``_ragged`` custom VJPs: its forward saves the residuals
``(q, k, v, positions, segment ids, o, lse)`` and its backward runs
:func:`mha_backward` on them, so a gradient through a CUDA tensor goes
through the backward kernel.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.launch import op_cost as _op_cost

NEG_INF = -1e30

HEAD_DIMS = (16, 32, 64, 128, 256)    # the kernels' instantiations
DECODE_MAX_T = 16  # K1 takes its decode form up to this many query rows
DECODE_TILE = 64   # keys per live tile of K1's decode form (its kBK)
BWD_QTILE = 64    # query rows per tile of the backward kernel (its kBQ)
# keys the backward kernel takes: its table of key-tile statistics holds
# kMaxKeyTiles = 512 tiles of 128
BWD_MAX_KEYS = 512 * 128

# Launches of each CUDA kernel, counted where the wrapper launches it
# (``_build.count_launch``): K1, and the fused backward (K2 and K3).
LAUNCHES = {"mha_forward": 0, "mha_backward": 0}
# the SMs K1's decode plan assumes for ``meta`` tensors when no card is
# present: an H100 SXM's
META_SM_COUNT = 132


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
# K1's decode form: the split plan on the host, and the split and merge in
# plain PyTorch (for the tests; the kernel finds its tiles on the card)
# ----------------------------------------------------------------------
def decode_plan(b: int, t: int, h: int, kv: int, s: int, d: int,
                n_sm: int) -> tuple[int, int]:
    """``(heads_per_block, n_split)`` of K1's decode form at kernel head
    dim ``d``: a pure function of the shapes and the SM count.

    A block takes ``heads_per_block`` q heads of a GQA group, all T
    positions each: the whole group where its G·T rows fit in 64 (32 at
    D 256), else as many heads as fit. The live key tiles of a batch row
    are cut into ``n_split`` splits, enough to put about two blocks on
    every SM, and never more than half the row's ``DECODE_TILE``-key tiles.
    """
    g = h // kv
    cap = 32 if d > 128 else 64
    gh = g if g * t <= cap else max(1, cap // t)
    blocks = b * kv * -(-g // gh)
    n_split = max(1, min(2 * n_sm // blocks, -(-s // DECODE_TILE) // 2))
    return gh, n_split


def decode_workspace_numel(n_split: int, b: int, t: int, h: int, kv: int,
                           d: int, heads_per_block: int) -> int:
    """Elements of the decode form's fp32 workspace, 0 with one split: each
    split's acc (B, T, H, d) and then its (m, l) per row, then one int32
    counter per (batch row, KV head and row group), which must be zero
    (the kernel leaves them so)."""
    groups = b * kv * -(-(h // kv) // heads_per_block)
    return 0 if n_split == 1 else n_split * b * t * h * (d + 2) + groups


def decode_live_tiles(q_positions, kv_positions, q_segment_ids=None,
                      kv_segment_ids=None, *, causal: bool,
                      window: int = 0) -> np.ndarray:
    """(B, n_tiles) bool: the ``DECODE_TILE``-key tiles the decode form
    visits for each batch row, its T query rows one tile: ``_live_terms``
    on each tile's min/max over its keys (the last tile's keys up to S)."""
    qp = np.asarray(q_positions).astype(np.int64)
    kp = np.asarray(kv_positions).astype(np.int64)
    b, s = kp.shape
    n = -(-s // DECODE_TILE)

    def key_mm(x):   # (B, n) min and max over each tile's keys
        lo = np.full((b, n * DECODE_TILE), np.iinfo(np.int64).max)
        hi = np.full((b, n * DECODE_TILE), np.iinfo(np.int64).min)
        lo[:, :s], hi[:, :s] = x, x
        return (lo.reshape(b, n, DECODE_TILE).min(2),
                hi.reshape(b, n, DECODE_TILE).max(2))

    qseg = kseg = None
    if q_segment_ids is not None:
        qs = np.asarray(q_segment_ids).astype(np.int64)
        qseg = (qs.min(1)[:, None], qs.max(1)[:, None])
        kseg = key_mm(np.asarray(kv_segment_ids).astype(np.int64))
    live = _live_terms((qp.min(1)[:, None], qp.max(1)[:, None]), key_mm(kp),
                       qseg, kseg, causal, window)
    return np.broadcast_to(np.asarray(live), (b, n)).copy()


def decode_split_tiles(live, n_split: int) -> list[list[np.ndarray]]:
    """``tiles[j][b]``: the tile indices split ``j`` takes in batch row
    ``b``, as the kernel cuts them: the row's live tiles in ascending
    order, ranks ``[n · j // n_split, n · (j + 1) // n_split)`` of its
    ``n`` live tiles."""
    rows = [np.flatnonzero(r) for r in np.asarray(live)]
    return [[r[len(r) * j // n_split:len(r) * (j + 1) // n_split]
             for r in rows] for j in range(n_split)]


def decode_partial_plain(q, k, v, q_positions, kv_positions,
                         q_segment_ids, kv_segment_ids, tiles, *, causal,
                         window=0, softcap=None):
    """One split's partial over the keys of ``tiles[b]`` (tile indices
    per batch row), in fp32: ``(acc, m, l)`` with acc (B, T, H, D) = Σ
    exp(s - m) v over the split's visible keys, m (B, H, T) their max
    score (NEG_INF where the split sees none) and l (B, H, T) = Σ exp(s - m)."""
    b, t, h, d = q.shape
    s = k.shape[1]
    group = h // k.shape[2]
    in_split = torch.zeros((b, s), dtype=torch.bool)
    for r, ts in enumerate(tiles):
        for tile in ts:
            in_split[r, tile * DECODE_TILE:(tile + 1) * DECODE_TILE] = True
    kf = _ref._repeat_kv(k, group).float()
    vf = _ref._repeat_kv(v, group).float()
    sc = torch.einsum("bthd,bshd->bhts", q.float(), kf) / math.sqrt(d)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    vis = in_split[:, None, None, :]
    mask = _element_mask(q_positions, kv_positions, q_segment_ids,
                         kv_segment_ids, causal, window)
    if mask is not None:
        vis = vis & mask
    sc = torch.where(vis, sc, NEG_INF)
    m = sc.amax(-1)
    p = torch.where(vis, torch.exp(sc - m[..., None]), 0.0)
    acc = torch.einsum("bhts,bshd->bthd", p, vf)
    return acc, m, p.sum(-1)


def decode_merge_plain(parts, dtype=torch.bfloat16):
    """``(o, lse)`` from the splits' partials ``[(acc, m, l), ...]`` in
    ascending split order: m = max m_j, l = Σ l_j exp(m_j - m), o = Σ acc_j
    exp(m_j - m) / l, lse = m + log l (l at least 1e-30, so a row no split
    sees gives o = 0 and the -1e30 sentinel)."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(m)
    for a, mj, lj in parts:
        w = torch.exp(mj - m)
        l = l + w * lj
        acc = acc + a * w.permute(0, 2, 1)[..., None]
    l = l.clamp_min(1e-30)
    o = acc / l.permute(0, 2, 1)[..., None]
    return o.to(dtype), m + torch.log(l)


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
    takes outside its kernels (``flash_attention.py:392``). The products of
    bf16 values are exact in fp32; one cast into a new tensor (a copy even
    where ``o`` is fp32, so ``o`` is never written), one product in place
    and one sum, no batched matrix product."""
    return (o.to(torch.float32, copy=True).mul_(do).sum(-1)
            .transpose(1, 2).contiguous())


def mha_backward_plain(q, k, v, q_positions, kv_positions,
                       q_segment_ids, kv_segment_ids, o, lse, do, *,
                       causal, window=0, softcap=None):
    """The backward kernel's function (the reference's K2 and K3) in plain
    PyTorch, from the same residuals:
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
def kernel_head_dim(d: int) -> int:
    """The kernels' instantiation that takes head dim ``d``: ``d`` itself,
    or the next one up, reached by zero-padding. Raises past 256."""
    for kd in HEAD_DIMS:
        if d <= kd:
            return kd
    raise NotImplementedError(
        f"head dim {d}: the CUDA kernels take at most {HEAD_DIMS[-1]}")


def softmax_scale(d: int) -> float:
    """1/sqrt(d) rounded to fp32 as the kernels computed it from their own
    head dim (``1.0f / sqrtf(D)``)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def pad_head(x, kd: int):
    """``x`` (..., d) with zero columns up to ``kd`` (``x`` itself at d == kd)."""
    return x if x.shape[-1] == kd else F.pad(x, (0, kd - x.shape[-1]))


def kernel_operands(*xs):
    """``(padded, sm_scale)``: the head-dim operands ``xs`` (..., d) zero-
    padded to ``kernel_head_dim(d)``, and the softmax scale of ``d`` itself.
    Zero columns add nothing to q k^T and come out as zeros, so cutting the
    outputs back to ``d`` columns gives the unpadded result exactly."""
    d = xs[0].shape[-1]
    kd = kernel_head_dim(d)
    return tuple(pad_head(x, kd) for x in xs), softmax_scale(d)


def _check_cuda_args(q, k, v, ints):
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA kernels are instantiated at head dims {HEAD_DIMS}, got "
            f"{d} (pad to kernel_head_dim)")
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


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device; for ``meta`` those
    of card 0, or ``META_SM_COUNT`` without a card."""
    if torch.device(device).type == "meta":
        if not torch.cuda.is_available():
            return META_SM_COUNT
        device = 0
    return torch.cuda.get_device_properties(device).multi_processor_count


# products over every (query, key) pair and head-dim column: K1's q kᵀ
# and p v; the backward's q kᵀ again, do vᵀ, pᵀ do, dsᵀ q and ds k
FORWARD_PRODUCTS, BACKWARD_PRODUCTS = 2, 5


def attention_cost(q, k, d: int, products: int) -> tuple[float, float]:
    """``(flops, padded_flops)`` charged to one launch of ``products``
    products on operands ``q`` (B,T,H,kd) and ``k`` (B,S,KV,kd) of true
    head dim ``d``: dense over every (query, key) pair, ``2·B·H·T·S·d``
    each, as the reference's ``ref`` path computes them (K1 ``4·B·H·T·S·d``,
    the backward ``10·B·H·T·S·d``); the columns past ``d`` apart."""
    b, t, h, kd = q.shape
    u = 2.0 * products * b * h * t * k.shape[1]
    return u * d, u * (kd - d)


def _launch_forward(q, k, v, q_positions, kv_positions, q_segment_ids,
                    kv_segment_ids, o, lse, ws, *, causal, window, softcap,
                    sm_scale, n_split=1, heads_per_block=0):
    """K1 alone, on checked tensors at one of ``HEAD_DIMS``: for T ≤
    ``DECODE_MAX_T`` the decode form with ``n_split`` splits and
    ``heads_per_block`` (from :func:`decode_plan`) and, with more than one
    split, ``ws``: fp32, contiguous, of exactly
    :func:`decode_workspace_numel` elements, its counters zero; raises on
    any other. An fp32 ``o`` (the decode form only) is written unrounded."""
    from repro_torch.kernels import _build
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    need = (decode_workspace_numel(n_split, b, t, h, kvh, d, heads_per_block)
            if t <= DECODE_MAX_T else 0)
    if need and (ws is None or ws.dtype != torch.float32 or ws.numel() != need
                 or ws.device != q.device or not ws.is_contiguous()):
        raise ValueError(
            f"the decode form's workspace must be contiguous fp32 of {need} "
            f"elements on {q.device}, got "
            + ("none" if ws is None else f"{ws.dtype} {ws.numel()}"))
    o_f32 = o.dtype == torch.float32
    if o_f32 and t > DECODE_MAX_T:
        raise ValueError("an fp32 o is the decode form's only (T <= "
                         f"{DECODE_MAX_T}), got T {t}")
    _build.launch(_build.library("flash_fwd").mha_fwd_bf16,
            _ptr(q), _ptr(k), _ptr(v), _ptr(q_positions), _ptr(kv_positions),
            _ptr(q_segment_ids), _ptr(kv_segment_ids), _ptr(o), _ptr(lse),
            _ptr(ws) if need else None, b, t, s, h, kvh, d, int(causal),
            int(window), float(softcap or 0.0), float(sm_scale), n_split,
            heads_per_block, need, int(o_f32), device=q.device)


def _mha_forward_cuda(q, k, v, q_positions, kv_positions,
                      q_segment_ids, kv_segment_ids, *,
                      causal, window, softcap, o_f32=False):
    """K1 on CUDA tensors; on ``meta`` tensors the same allocations and
    no launch. Either way one launch is charged to the open
    ``op_cost`` counters. With ``o_f32`` (the decode form only) o is fp32,
    unrounded."""
    from repro_torch.kernels import _build
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    (q, k, v), sm_scale = kernel_operands(q, k, v)
    kd = q.shape[-1]
    _check_cuda_args(q, k, v, _int_args(q, k, q_positions, kv_positions,
                                        q_segment_ids, kv_segment_ids))
    o = torch.empty_like(q, dtype=torch.float32 if o_f32 else q.dtype)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    gh, n_split, ws = 0, 1, None
    if t <= DECODE_MAX_T:
        gh, n_split = decode_plan(b, t, h, kvh, s, kd, sm_count(q.device))
        if n_split > 1:   # one allocation and one fill: the counters zeroed
            ws = torch.zeros(decode_workspace_numel(n_split, b, t, h, kvh, kd, gh),
                             dtype=torch.float32, device=q.device)
    if q.device.type != "meta":
        _launch_forward(q, k, v, q_positions, kv_positions, q_segment_ids,
                        kv_segment_ids, o, lse, ws, causal=causal,
                        window=window, softcap=softcap, sm_scale=sm_scale,
                        n_split=n_split, heads_per_block=gh)
        _build.count_launch(LAUNCHES, "mha_forward")
    flops, padded = attention_cost(q, k, d, FORWARD_PRODUCTS)
    _op_cost.charge("mha_forward", flops,
                    (q, k, v, q_positions, kv_positions, q_segment_ids,
                     kv_segment_ids), (o, lse, ws), padded)
    return (o if kd == d else o[..., :d].contiguous()), lse


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
    """Everything the backward kernel assumes of its arguments: device, dtype,
    shape (at most ``BWD_MAX_KEYS`` keys), alignment and contiguity. Raises
    on the first that fails."""
    _check_cuda_args(q, k, v, _int_args(q, k, q_positions, kv_positions,
                                        q_segment_ids, kv_segment_ids))
    if k.shape[1] > BWD_MAX_KEYS:
        raise ValueError(f"the backward kernel takes at most {BWD_MAX_KEYS} "
                         f"keys, got {k.shape[1]}")
    _check_bwd_args(q, o, lse, do, delta)


def dq_from_accumulator(acc, t):
    """dq (B,T,H,D) bf16 from the backward kernel's fp32 accumulator
    (B,H,T rounded up to the query tile,D), which already holds
    ds k / sqrt(D): rows past T dropped, transposed and cast in one copy."""
    b, h, _, d = acc.shape
    dq = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=acc.device)
    dq.permute(0, 2, 1, 3).copy_(acc[:, :, :t])
    return dq


def _launch_backward(q, k, v, q_positions, kv_positions, q_segment_ids,
                     kv_segment_ids, o, lse, do, delta, acc, dk, dv, *,
                     causal, window, softcap, sm_scale, sem=None):
    """The kernel alone, on tensors at one of ``HEAD_DIMS`` (padded by
    :func:`kernel_operands`, which also gives ``sm_scale``): adds ds k x
    ``sm_scale`` into ``acc`` in ascending key tile,
    ordered by the zeroed counters ``sem`` (allocated here when not given),
    and writes dk and dv. The kernel refuses an ``acc`` whose third dim is
    not T rounded up to its own query tile. ``meta`` tensors launch
    nothing."""
    from repro_torch.kernels import _build
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if (acc.dtype != torch.float32 or acc.dim() != 4
            or (acc.shape[0], acc.shape[1], acc.shape[3]) != (b, h, d)
            or acc.device != q.device or not acc.is_contiguous()):
        raise ValueError(f"the dq accumulator must be contiguous fp32 "
                         f"({b}, {h}, T_pad, {d}) on {q.device}, got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    n_qt = -(-acc.shape[2] // BWD_QTILE)
    if sem is None:
        sem = torch.zeros((b, h, n_qt), dtype=torch.int32, device=q.device)
    if (sem.dtype != torch.int32 or sem.shape != (b, h, n_qt)
            or sem.device != q.device or not sem.is_contiguous()):
        raise ValueError(f"the dq counters must be contiguous int32 "
                         f"({b}, {h}, {n_qt}) on {q.device}, got "
                         f"{sem.dtype} {tuple(sem.shape)}")
    if q.device.type == "meta":
        return
    _build.launch(_build.library("flash_bwd").mha_bwd_bf16,
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(q_positions), _ptr(kv_positions), _ptr(q_segment_ids),
            _ptr(kv_segment_ids), _ptr(acc), acc.shape[2], _ptr(sem),
            _ptr(dk), _ptr(dv), b, t, s, h, kvh, d, int(causal), int(window),
            float(softcap or 0.0), float(sm_scale), device=q.device)
    _build.count_launch(LAUNCHES, "mha_backward")


def dq_accumulator(q):
    """The backward kernel's zeroed dq scratch, from one allocation and one
    fill: ``(acc, sem)``, the fp32 accumulator (B, H, T rounded up to
    BWD_QTILE, D) it adds into, one contiguous block per tile, and the int32
    counters (B, H, T rounded up / BWD_QTILE) that order those adds."""
    b, t, h, d = q.shape
    n_qt = -(-t // BWD_QTILE)
    n = b * h * n_qt * BWD_QTILE * d
    buf = torch.zeros(n + b * h * n_qt, dtype=torch.float32, device=q.device)
    return (buf[:n].view(b, h, n_qt * BWD_QTILE, d),
            buf[n:].view(torch.int32).view(b, h, n_qt))


def mha_backward_cuda(q, k, v, q_positions, kv_positions, q_segment_ids,
                      kv_segment_ids, o, lse, do, delta, *, causal, window,
                      softcap):
    """Check the arguments, then launch the fused backward kernel once:
    ``(dq, dk, dv)``, dq (B,T,H,D) and dk, dv (B,S,KV,D) bf16, dk and dv
    summed over each GQA group. Arguments as :func:`mha_backward`, plus
    ``delta`` from :func:`attention_delta`. The kernel takes at most
    ``BWD_MAX_KEYS`` (65536) keys; more raise. A head dim between the
    kernel's instantiations is zero-padded and cut back. ``meta`` tensors
    get the same allocations and no launch; either way one launch is
    charged to the open ``op_cost`` counters."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"mha_backward_cuda takes CUDA tensors (or meta "
                         f"ones, which launch nothing), got {q.device}")
    d = q.shape[-1]
    (q, k, v, o, do), sm_scale = kernel_operands(q, k, v, o, do)
    args = (q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, o, lse, do, delta)
    check_backward_cuda_args(*args)
    acc, sem = dq_accumulator(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_backward(*args, acc, dk, dv, causal=causal, window=window,
                     softcap=softcap, sm_scale=sm_scale, sem=sem)
    flops, padded = attention_cost(q, k, d, BACKWARD_PRODUCTS)
    _op_cost.charge("mha_backward", flops, args, (acc, sem, dk, dv), padded)
    dq = dq_from_accumulator(acc, q.shape[1])
    if q.shape[-1] == d:
        return dq, dk, dv
    return tuple(x[..., :d].contiguous() for x in (dq, dk, dv))


def _check_softcap(softcap):
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")


def mha_forward(q, k, v, q_positions, kv_positions,
                q_segment_ids=None, kv_segment_ids=None, *,
                causal, window=0, softcap=None):
    """Raw forward: returns ``(o, lse)`` with lse in (B, H, T) fp32.

    q (B,T,H,D), k/v (B,S,KV,D) with H % KV == 0; positions and segment ids
    (B,T)/(B,S) int32, segment ids -1 on padding. CUDA tensors launch K1
    (bf16, contiguous, D at most 256: a D between the ``HEAD_DIMS`` is
    zero-padded); CPU tensors take the plain version; ``meta`` tensors (a
    dry run) get K1's allocations and outputs, and no launch.
    """
    _check_softcap(softcap)
    if q.device.type in ("cuda", "meta"):
        return _mha_forward_cuda(
            q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
            causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return mha_forward_plain(
            q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
            causal=causal, window=window, softcap=softcap)
    raise ValueError(f"no attention path for device {q.device}")


def mha_partial(q, k, v, q_positions, kv_positions, *, causal, window=0,
                softcap=None):
    """:func:`mha_forward` with o in fp32, unrounded: one slice's partial
    for a merge over a KV cache split by sequence. CUDA and ``meta``
    tensors take K1's decode form (T ≤ ``DECODE_MAX_T``); CPU tensors the
    plain version in fp32 (its scores and sums are fp32 either way)."""
    _check_softcap(softcap)
    if q.device.type in ("cuda", "meta"):
        return _mha_forward_cuda(q, k, v, q_positions, kv_positions, None,
                                 None, causal=causal, window=window,
                                 softcap=softcap, o_f32=True)
    if q.device.type == "cpu":
        return mha_forward_plain(q.float(), k, v, q_positions, kv_positions,
                                 causal=causal, window=window, softcap=softcap)
    raise ValueError(f"no attention path for device {q.device}")


def mha_backward(q, k, v, q_positions, kv_positions, q_segment_ids,
                 kv_segment_ids, o, lse, do, *, causal, window=0,
                 softcap=None):
    """Backward from the forward's residuals: returns ``(dq, dk, dv)``.

    CUDA tensors launch the fused backward kernel once, after the plain
    reduction ``delta = rowsum(do * o)``; ``meta`` tensors make the same
    allocations and launch nothing; CPU tensors take
    :func:`mha_backward_plain`.
    """
    _check_softcap(softcap)
    args = (q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, o, lse, do)
    opts = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type in ("cuda", "meta"):
        return mha_backward_cuda(*args, attention_delta(o, do), **opts)
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

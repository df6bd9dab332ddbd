"""Mamba2 SSD: the CUDA kernel K4, its backward, and their plain versions.

Counterpart of ``repro.kernels.ssd.ssd_chunked``. :func:`ssd_chunked` takes
the path its tensors' device gives: on a CUDA tensor it launches K4
(``csrc/ssd_fwd.cu``) or raises, and where a gradient is needed K4's
backward (``csrc/ssd_bwd.cu``) through :class:`_SSDFunction`; on a CPU
tensor it runs the plain version, ``ref.ssd_ref_chunked``, under ordinary
autograd. There is no fallback from one to the other. A ``meta`` tensor (a
dry run) gets the kernels' allocations and outputs and no launch, and every
launch or would-be launch is charged to the open ``launch/op_cost.py``
counters by :func:`ssd_cost` and :func:`ssd_bwd_cost`.

K4 replaces the TPU kernel ``ssd_chunked`` (``src/repro/kernels/ssd.py``,
``pl.pallas_call`` at :114, body ``_ssd_kernel`` at :31). At mamba2-130m's
serve shape it is bound by bytes (x and y, B and C, dt, the state: 117 MB
at B 8, T 2048), with operations (23 GFLOP at 64-step chunks) behind. Where
the TPU carried the state in VMEM across its sequential chunk axis, one
block per (head, batch row) walks the chunks with the state in registers,
all blocks in flight together, every product on the tensor cores (bf16
operands, an fp32 operand split into two bf16 parts, fp32 sums): per
chunk C Bᵀ, then y from W = (C Bᵀ) ∘ L ∘ dt and from the state at the
chunk's start, then the state's update. No chunk states cross device
memory on the serving path; asked for, K4 also writes them (as bf16 hi and
lo parts) so that a check can hold the recurrence and y apart, against
``ref.ssd_chunk_parallel``, the plain form of the same steps. Repeatable
bit for bit. Any T works (the last chunk is zero-filled), where the
reference asserts that T is a multiple of its 128-step chunk. K4 also
starts from a given fp32 state (ROADMAP A17), which no caller of the
reference passes. The source's header says more.

The reference has no gradient for its kernel: it differentiates the plain
chunked oracle. The port's backward is a kernel of its own, designed from
the algebra, in two passes: a reverse walk per (batch row, head, 64
columns of the state) that carries only dS', the gradient of each chunk's
end state, and writes it for every chunk; then every chunk at once, one
block per (batch row, chunk, tile of a group's heads), from each chunk's
start state (the ``chunk_states`` that K4 writes when the forward needs a
gradient) and its dS', with C Bᵀ once for the tile's heads and dB and dC
summed over them in registers. dA, and dB and dC where a group's heads are
split over tiles, are merged in a fixed order by the last block to count
itself on a counter (zeroed by the walk), so the backward too is
repeatable bit for bit.
``ref.ssd_chunked_bwd_parallel`` is the same two passes in plain PyTorch,
``ref.ssd_chunked_bwd`` the same function as one plain reverse walk.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.launch import op_cost as _op_cost

# Launches of K4 and of its backward, counted where the wrappers launch
# them (``_build.count_launch``).
LAUNCHES = {"ssd_chunked": 0, "ssd_backward": 0}

CHUNK = 64                     # K4's chunk length (kL in ssd_fwd.cu)
# how K4 takes the operands of its products (split: hi = bf16(v) and
# lo = bf16(v - hi), one mma each); every sum is fp32
PRECISION = {
    "C B^T": "bf16 x bf16 (the inputs' own type)",
    "W = (C B^T) o L o dt, times x": "W split into bf16 hi + lo",
    "(x o e^(a_tot - cum) dt)^T B": "x o e^(a_tot - cum) dt split into "
                                    "bf16 hi + lo",
    "C S^T, S the carried state": "S split into bf16 hi + lo",
}
# how the backward takes them: C Bᵀ and dy xᵀ as bf16 x bf16; every other
# product has one fp32 operand, split into hi + lo
BWD_PRECISION = {
    "C B^T, dy x^T": "bf16 x bf16 (the inputs' own type)",
    "W^T dy, M B, M^T C (W, M = (.) o L o dt)": "W, M split into bf16 hi + lo",
    "B dS'^T, x dS', dS' the carried gradient": "dS' split into bf16 hi + lo",
    "dy S, S the chunk's start state": "S as K4 writes it: bf16 hi + lo",
    "(E o dy)^T C": "E o dy split into bf16 hi + lo",
}


def check_cuda_args(x, dt, A, B, C, initial_state=None):
    """What K4 assumes of its arguments and its launcher cannot see: device,
    dtype, shape and the strides and alignment it can read (rows of x, B
    and C by 16 bytes). Raises on the first that fails. The launcher itself
    refuses the sizes it cannot take (head dims or states not a multiple of
    16 or past 128, more than 65535 batch rows) with an error code."""
    b, t, h, _ = x.shape
    g = B.shape[2]
    if dt.shape != (b, t, h) or A.shape != (h,) or B.shape[:2] != (b, t) \
            or C.shape != B.shape or h % g:
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B.shape)} "
                         f"C {tuple(C.shape)}")
    for name, v, dtype in (("x", x, torch.bfloat16), ("B", B, torch.bfloat16),
                           ("C", C, torch.bfloat16), ("dt", dt, torch.float32),
                           ("A", A, torch.float32)):
        if v.dtype != dtype:
            raise TypeError(f"K4 takes {dtype} {name}; it is {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    for name, v in (("x", x), ("B", B), ("C", C)):
        if v.stride(-1) != 1 and v.shape[-1] > 1:
            raise ValueError(f"the last axis of {name} must be contiguous; "
                             f"strides {v.stride()}")
        if v.data_ptr() % 16 or any(st % 8 for st in v.stride()[:3]):
            raise ValueError(f"K4 reads rows of {name} by 16 bytes: its "
                             f"address and strides {v.stride()[:3]} must be "
                             f"16-byte aligned")
    if A.stride(0) != 1 and h > 1:
        raise ValueError(f"A must be contiguous; stride {A.stride()}")
    if initial_state is not None:
        _check_state("initial_state", initial_state, x, B)


def _check_state(name, v, x, B):
    """A (B, H, P, N) fp32 state beside x (an initial state, or the
    gradient of the final one)."""
    want = (x.shape[0], x.shape[2], x.shape[3], B.shape[3])
    if tuple(v.shape) != want or v.dtype != torch.float32 \
            or v.device != x.device:
        raise ValueError(f"{name} must be fp32 {want} on {x.device}; it is "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")


def kernel_p(p: int) -> int:
    """K4's instantiation for head dim ``p`` (its ``kP``)."""
    return next((k for k in (16, 32, 64, 128) if p <= k), p)


def ssd_cost(b: int, t: int, h: int, p: int, n: int,
             initial_state: bool = False) -> tuple[float, float]:
    """``(flops, padded_flops)`` of one K4 launch: the products its loop
    issues (``csrc/ssd_fwd.cu``), per (head, batch row) and 64-step chunk,
    with kP its instantiation of P. C Bᵀ for each 16-row strip up to the
    diagonal, 10 blocks of 16 x 16 by N, made by both warps of a strip when
    kP > 16; W x on the same 10 blocks, by kP columns, as hi and lo; the
    start state's C Sᵀ, 64 x kP by N as hi and lo, in every chunk but the
    first (in the first too from an ``initial_state``); the state's update
    (x ∘ u)ᵀ B, P x N by 64, as hi and lo. The columns of kP past P go to
    ``padded_flops``."""
    kp = kernel_p(p)
    nc = -(-t // CHUNK)
    blk = 2 * 16 * 16           # one 16 x 16 block, per unit of K or N
    starts = nc if initial_state else nc - 1

    def total(cols):
        dup = 2 if kp > 16 else 1
        per_chunk = 10 * blk * n * dup + 2 * 10 * blk * cols + 4 * p * n * CHUNK
        return b * h * (nc * per_chunk + starts * 4 * CHUNK * n * cols)
    return float(total(p)), float(total(kp) - total(p))


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, t: int, h: int, g: int, sms: int) -> tuple[int, int]:
    """``(heads a tile, tiles a group)`` of the backward's chunk pass, one
    block of which takes (batch row, chunk, tile) and walks the tile's
    heads: the fewest tiles whose waves of blocks (one an SM, ``sms`` of
    them) times the heads a block walks (and one for its own loads) are
    least. One tile needs no partial sums of dB and dC."""
    rep = h // g
    base = b * -(-t // CHUNK) * g
    best = None
    for nt in range(1, rep + 1):
        ht = -(-rep // nt)
        if -(-rep // ht) != nt:     # the same tiles as fewer of them
            continue
        cost = -(-base * nt // sms) * (ht + 1)
        if best is None or cost < best[0]:
            best = (cost, ht, nt)
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def bwd_workspace(b: int, t: int, h: int, p: int, n: int, g: int,
                  nt: int) -> tuple[tuple[int, int, int, int], int]:
    """The byte offsets and total size of the backward's workspace, one
    allocation: dS' of every chunk, bf16 hi and lo (B, H, chunks, 2, P, N);
    dA's shares, fp32 (B, chunks, H); where ``nt`` tiles split a group's
    heads, their fp32 dB and dC (nt, 2, B, T, G, N); the merges' int32
    counters (G nt + B chunks G). Each part starts on 256 bytes."""
    nc = -(-t // CHUNK)
    sizes = (b * h * nc * 2 * p * n * 2, b * nc * h * 4,
             (nt > 1) * nt * 2 * b * t * g * n * 4, (g * nt + b * nc * g) * 4)
    offs, at = [], 0
    for size in sizes:
        offs.append(at)
        at += -(-size // 256) * 256
    return tuple(offs), at


@functools.lru_cache(maxsize=256)
def ssd_bwd_cost(b: int, t: int, h: int, p: int, n: int, g: int = 1,
                 tiles: int = 1) -> tuple[float, float]:
    """``(flops, padded_flops)`` of one launch of K4's backward: the
    products its passes issue (``csrc/ssd_bwd.cu``), with kP its
    instantiation of P and ``tiles`` the chunk pass's head tiles a group.
    Per (head, batch row) and 64-step chunk: the dS' walk's (E ∘ dy)ᵀ C, P
    x N by 64, as hi and lo; in the chunk pass B dS'ᵀ, 64 x (P rounded up
    to its slices of 32 rows, 16 at kP 16) by N, as hi and lo; dy S and x
    dS', 64 x N by P, as hi and lo, each; dy xᵀ on the 10 blocks of 16 x 16
    up to the diagonal, by P; Wᵀ dy on them, by kP columns, as hi and lo; M
    B and Mᵀ C on them, by N, as hi and lo, each. Per (batch row, chunk,
    group and head tile): C Bᵀ on the 10 blocks, by N, shared by the tile's
    heads. The columns past P go to ``padded_flops``."""
    kp = kernel_p(p)
    slice_rows = min(kp, 32)
    nc = -(-t // CHUNK)
    blk = 2 * 16 * 16

    def total(q_cols, w_cols):
        per_chunk = (4 * CHUNK * p * n + 4 * CHUNK * q_cols * n
                     + 2 * 4 * CHUNK * p * n + 10 * blk * p
                     + 2 * 10 * blk * w_cols + 2 * 2 * 10 * blk * n)
        return b * h * nc * per_chunk + b * nc * g * tiles * 10 * blk * n
    return float(total(p, p)), float(
        total(-(-p // slice_rows) * slice_rows, kp) - total(p, p))


def bwd_smem_bytes(p: int, n: int) -> tuple[int, int]:
    """The dynamic shared memory of the backward's two passes at head dim
    ``p`` and state ``n`` (``Smem1`` and ``Smem2`` in ``csrc/ssd_bwd.cu``):
    the dS' walk's staging tiles (two a warp, each its 16 rows of dS' by
    the block's 64 columns, hi and lo), two stages of dy and 64 columns of
    C in bf16 (rows padded by 8) and dt, each warp's E, and 1024 bytes of
    slack; the chunk pass's two slots of S and dS' slices (32 rows of P, hi
    and lo, as TMA boxes of 64 columns), B and C, two slots of x and dy, W
    and M as hi and lo, in bf16 (rows other than the boxes' padded by 8),
    then 3240 floats, two mbarriers, two flags and 1024 bytes of slack for
    the boxes' alignment."""
    kp, chunk = kernel_p(p), CHUNK
    warps = kp // 16
    walk = (warps * 2 * (2 * 16 * 64 * 2)
            + 2 * (2 * chunk * (kp + 8 + 64 + 8) + 4 * chunk)
            + warps * 4 * chunk + 1024)
    elems = (2 * 8 * min(kp, 32) * 64 + 4 * chunk * (kp + 8)
             + 2 * chunk * (n + 8) + 4 * chunk * (chunk + 8))
    return walk, 2 * elems + 3240 * 4 + 24 + 1024


def _ssd_launch(x, dt, A, B, C, initial_state, chunk_states):
    """One K4 launch (or, on ``meta``, its allocations): ``(y,
    final_state, starts)``, starts the raw bf16 (B, H, chunks - 1, 2, P,
    N) hi and lo parts of the chunk-start states, or None."""
    from repro_torch.kernels import _build
    check_cuda_args(x, dt, A, B, C, initial_state)
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if initial_state is not None:
        initial_state = initial_state.contiguous()
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    starts = (torch.empty((b, h, -(-t // CHUNK) - 1, 2, p, n),
                          dtype=torch.bfloat16, device=x.device)
              if chunk_states else None)
    if x.device.type != "meta":
        _build.launch(
            _build.library("ssd_fwd").ssd_fwd_bf16,
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(),
            starts.data_ptr() if chunk_states else None,
            None if initial_state is None else initial_state.data_ptr(),
            b, t, h, g, p, n,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            device=x.device)
        _build.count_launch(LAUNCHES, "ssd_chunked")
    flops, padded = ssd_cost(b, t, h, p, n, initial_state is not None)
    _op_cost.charge("ssd_chunked", flops, (x, dt, A, B, C, initial_state),
                    (y, state, starts), padded)
    return y, state, starts


def _ssd_cuda(x, dt, A, B, C, *, chunk_states=False, initial_state=None):
    """K4: ``(y, final_state)``, from a zero state or ``initial_state``
    (B, H, P, N) fp32, and with ``chunk_states`` also the state at the
    start of every chunk after the first, which K4 then writes as hi and
    lo parts: hi + lo in fp32 (B, H, chunks - 1, P, N). ``meta`` tensors
    get the same allocations and no launch; either way one launch is
    charged to the open ``op_cost`` counters. No gradient flows through
    it: :func:`ssd_chunked` takes :class:`_SSDFunction` for that."""
    y, state, starts = _ssd_launch(x, dt, A, B, C, initial_state,
                                   chunk_states)
    if chunk_states:
        return y, state, starts[:, :, :, 0].float() + starts[:, :, :, 1].float()
    return y, state


def _ssd_bwd_cuda(x, dt, A, B, C, dy, starts, d_final=None,
                  initial_state=None, return_dstates=False, pass_events=None):
    """K4's backward: ``(dx, ddt, dA, dB, dC, d_initial)`` from dy (the
    gradient of y), ``starts`` (K4's raw chunk-start states, as
    :func:`_ssd_launch` returns them), and ``d_final`` (the gradient of the
    final state, or None for zero); the first chunk starts from
    ``initial_state``, or zero. dx in x's dtype, dB and dC in B's, ddt, dA
    and d_initial in fp32. Its workspace, one allocation
    (:func:`bwd_workspace`): dS' of every chunk (of the last, d_final or
    zero), bf16 hi and lo in the layout of ``starts``; dA's shares per
    (batch row, chunk, head); where :func:`bwd_plan` splits a group's
    heads, each tile's fp32 dB and dC; the counters of the merges, which
    the first pass zeroes. ``meta`` tensors get every allocation of the
    card and no launch; either way the two passes count as one launch,
    charged to the open ``op_cost`` counters. For a check or
    a timing, ``return_dstates`` also returns the first pass's dS' as hi +
    lo in fp32 (B, H, chunks, P, N), and ``pass_events`` (three CUDA
    events) are recorded before, between and after the two passes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import sm_count
    check_cuda_args(x, dt, A, B, C, initial_state)
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-t // CHUNK)
    if p % 16 or p > 128 or n % 16 or n > 128:
        raise ValueError(f"K4's backward takes head dims and states that are "
                         f"multiples of 16 up to 128; they are {p} and {n}")
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)}; it is "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if dy.stride(-1) != 1 or dy.data_ptr() % 16 or any(
            st % 8 for st in dy.stride()[:3]):
        dy = dy.contiguous()
    if starts.shape != (b, h, nc - 1, 2, p, n) or \
            starts.dtype != torch.bfloat16 or not starts.is_contiguous():
        raise ValueError(f"starts must be K4's contiguous bf16 "
                         f"{(b, h, nc - 1, 2, p, n)}; they are "
                         f"{starts.dtype} {tuple(starts.shape)}")
    for name, v in (("d_final", d_final), ("initial_state", initial_state)):
        if v is not None:
            _check_state(name, v, x, B)
    d_final = None if d_final is None else d_final.contiguous()
    initial_state = (None if initial_state is None
                     else initial_state.contiguous())
    dev, f32 = x.device, torch.float32
    ht, nt = bwd_plan(b, t, h, g, sm_count(dev))
    dx = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, t, h), dtype=f32, device=dev)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dB = torch.empty((b, t, g, n), dtype=B.dtype, device=dev)
    dC = torch.empty((b, t, g, n), dtype=B.dtype, device=dev)
    d_init = torch.empty((b, h, p, n), dtype=f32, device=dev)
    offs, nbytes = bwd_workspace(b, t, h, p, n, g, nt)
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    if dev.type != "meta":
        dstates, part_a, part_bc, count = (ws.data_ptr() + o for o in offs)

        def run(passes):
            _build.launch(
                _build.library("ssd_bwd").ssd_bwd_bf16,
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), dy.data_ptr(), starts.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                None if d_final is None else d_final.data_ptr(),
                dstates, dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                dB.data_ptr(), dC.data_ptr(), d_init.data_ptr(),
                part_bc if nt > 1 else None, part_a, count, b, t, h, g, p,
                n, ht, passes, *x.stride()[:3], *dt.stride(), *B.stride()[:3],
                *C.stride()[:3], *dy.stride()[:3], device=dev)
        if pass_events is None:
            run(3)
        else:
            for i, passes in enumerate((1, 2)):
                pass_events[i].record()
                run(passes)
            pass_events[2].record()
        _build.count_launch(LAUNCHES, "ssd_backward")
    flops, padded = ssd_bwd_cost(b, t, h, p, n, g, nt)
    _op_cost.charge("ssd_backward", flops,
                    (x, dt, A, B, C, dy, starts, d_final, initial_state),
                    (dx, ddt, dA, dB, dC, d_init), padded)
    grads = dx, ddt, dA, dB, dC, d_init
    if return_dstates:
        ds = ws[:offs[1]].view(torch.bfloat16)[:b * h * nc * 2 * p * n].view(
            b, h, nc, 2, p, n)
        return grads, ds[:, :, :, 0].float() + ds[:, :, :, 1].float()
    return grads


class _SSDFunction(torch.autograd.Function):
    """K4 under autograd: the forward launches K4 and keeps its chunk-start
    states for the backward, which launches K4's backward. The gradient of
    the final state, where it is used, flows back through ``d_final``;
    where it is not, autograd passes None and the walk starts from zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state):
        y, state, starts = _ssd_launch(x, dt, A, B, C, initial_state, True)
        ctx.save_for_backward(x, dt, A, B, C, initial_state, starts)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, A, B, C, initial_state, starts = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = _ssd_bwd_cuda(x, dt, A, B, C, dy, starts, d_final,
                              initial_state)
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad))


def ssd_serial_cuda(x, dt, A, B, C):
    """K4's first, serial form (``csrc/ssd_fwd_serial.cu``): the same
    function, one block per (head, batch row) walking the chunks in fp32
    FMA. A yardstick that ``chip_smoke.py`` times beside K4; no path calls
    it, and its launches are not counted."""
    from repro_torch.kernels import _build
    check_cuda_args(x, dt, A, B, C)
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    _build.launch(
        _build.library("ssd_fwd_serial").ssd_fwd_serial_bf16,
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, t, h, g, p, n,
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        device=x.device)
    return y, state


def ssd_chunked(x, dt, A, B, C, initial_state=None):
    """Mamba2 SSD over full sequences from a zero state, or from
    ``initial_state`` (B,H,P,N) fp32: ``(y, final_state)``.

    x (B,T,H,P), dt (B,T,H) > 0, A (H,) < 0, B/C (B,T,G,N) with H % G == 0;
    y (B,T,H,P) in x's dtype, final_state (B,H,P,N) fp32. CUDA tensors
    launch K4 (x, B, C bf16; dt, A fp32; the last axis of x, B and C
    contiguous, their rows 16-byte aligned), and where a gradient is needed
    K4's backward; CPU tensors take the plain version (the quadratic oracle
    from an initial state, as the reference's ``ops.ssd`` does); ``meta``
    tensors (a dry run) get the kernels' allocations and outputs, and no
    launch.
    """
    if x.device.type in ("cuda", "meta"):
        if torch.is_grad_enabled() and any(
                v is not None and v.requires_grad
                for v in (x, dt, A, B, C, initial_state)):
            return _SSDFunction.apply(x, dt, A, B, C, initial_state)
        return _ssd_cuda(x, dt, A, B, C, initial_state=initial_state)
    if x.device.type == "cpu":
        if initial_state is None:
            return _ref.ssd_ref_chunked(x, dt, A, B, C)
        return _ref.ssd_ref(x, dt, A, B, C, initial_state=initial_state,
                            return_state=True)
    raise ValueError(f"no SSD path for device {x.device}")

"""Mamba2 SSD forward: the CUDA kernel K4 and its plain PyTorch version.

Counterpart of ``repro.kernels.ssd.ssd_chunked``. :func:`ssd_chunked` takes
the path its tensors' device gives: on a CUDA tensor it launches K4
(``csrc/ssd_fwd.cu``) or raises, on a CPU tensor it runs
its plain version, ``ref.ssd_ref_chunked``. There is no fallback
from one to the other. A ``meta`` tensor (a dry run) gets K4's allocations
and outputs and no launch, and every launch or would-be launch is charged
to the open ``launch/op_cost.py`` counters by :func:`ssd_cost`.

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
reference asserts that T is a multiple of its 128-step chunk. The source's
header says more.

The reference has no gradient for its kernel, and neither has K4: a CUDA
tensor that requires grad raises. On the CPU the plain version is ordinary
autograd code, as the reference differentiates its ``ref`` path there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.launch import op_cost as _op_cost

# Launches of K4, counted where the wrapper launches it
# (``_build.count_launch``).
LAUNCHES = {"ssd_chunked": 0}

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


def check_cuda_args(x, dt, A, B, C):
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


def kernel_p(p: int) -> int:
    """K4's instantiation for head dim ``p`` (its ``kP``)."""
    return next((k for k in (16, 32, 64, 128) if p <= k), p)


def ssd_cost(b: int, t: int, h: int, p: int, n: int) -> tuple[float, float]:
    """``(flops, padded_flops)`` of one K4 launch: the products its loop
    issues (``csrc/ssd_fwd.cu``), per (head, batch row) and 64-step chunk,
    with kP its instantiation of P. C Bᵀ for each 16-row strip up to the
    diagonal, 10 blocks of 16 x 16 by N, made by both warps of a strip when
    kP > 16; W x on the same 10 blocks, by kP columns, as hi and lo; the
    start state's C Sᵀ, 64 x kP by N as hi and lo, in every chunk but the
    first; the state's update (x ∘ u)ᵀ B, P x N by 64, as hi and lo. The
    columns of kP past P go to ``padded_flops``."""
    kp = kernel_p(p)
    nc = -(-t // CHUNK)
    blk = 2 * 16 * 16           # one 16 x 16 block, per unit of K or N

    def total(cols):
        dup = 2 if kp > 16 else 1
        per_chunk = 10 * blk * n * dup + 2 * 10 * blk * cols + 4 * p * n * CHUNK
        return b * h * (nc * per_chunk + (nc - 1) * 4 * CHUNK * n * cols)
    return float(total(p)), float(total(kp) - total(p))


def _ssd_cuda(x, dt, A, B, C, *, chunk_states=False):
    """K4: ``(y, final_state)``, and with ``chunk_states`` also the state at
    the start of every chunk after the first, which K4 then writes as hi and
    lo parts: hi + lo in fp32 (B, H, chunks - 1, P, N). ``meta`` tensors get
    the same allocations and no launch; either way one launch is charged to
    the open ``op_cost`` counters."""
    from repro_torch.kernels import _build
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, dt, A, B, C)):
        raise NotImplementedError(
            "K4 has no backward, as the reference's ssd_chunked has none: "
            "Mamba training on the card is an open question (ROADMAP, D)")
    check_cuda_args(x, dt, A, B, C)
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
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
            starts.data_ptr() if chunk_states else None, b, t, h, g, p, n,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            device=x.device)
        _build.count_launch(LAUNCHES, "ssd_chunked")
    flops, padded = ssd_cost(b, t, h, p, n)
    _op_cost.charge("ssd_chunked", flops, (x, dt, A, B, C),
                    (y, state, starts), padded)
    if chunk_states:
        return y, state, starts[:, :, :, 0].float() + starts[:, :, :, 1].float()
    return y, state


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


def ssd_chunked(x, dt, A, B, C):
    """Mamba2 SSD over full sequences from a zero state: ``(y, final_state)``.

    x (B,T,H,P), dt (B,T,H) > 0, A (H,) < 0, B/C (B,T,G,N) with H % G == 0;
    y (B,T,H,P) in x's dtype, final_state (B,H,P,N) fp32. CUDA tensors
    launch K4 (x, B, C bf16; dt, A fp32; the last axis of x, B and C
    contiguous, their rows 16-byte aligned); CPU tensors take the plain
    version; ``meta`` tensors (a dry run) get K4's allocations and outputs,
    and no launch.
    """
    if x.device.type in ("cuda", "meta"):
        return _ssd_cuda(x, dt, A, B, C)
    if x.device.type == "cpu":
        return _ref.ssd_ref_chunked(x, dt, A, B, C)
    raise ValueError(f"no SSD path for device {x.device}")

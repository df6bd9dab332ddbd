#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --phases kernel # only the build and the kernel checks
    python3 chip_smoke.py --phases profile  # where the serve path's time goes

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit, and the build of every CUDA
             kernel of the serving path from the sources in this checkout;
2. kernel  — K1 (``mha_forward``) against its plain PyTorch version on the
             card, at the serving path's shapes and on small cases (GQA,
             window, softcap, segmented with padding and fully masked rows,
             ragged lengths), with times of the kernel, the plain version
             and ``scaled_dot_product_attention`` (a yardstick the port never
             calls) beside the least time the card could take;
3. serve   — ``repro_torch.serve`` at full gpt-paper width, 32 layers,
             random seeded weights: the launch count of K1 must equal
             n_layers x (prefill batches x (1 + decode steps)) and every
             logit must be finite; then the same serve with 2 layers runs
             once with K1 and once with the plain attention, and their
             logits must agree;
4. profile — (not run by default) torch.profiler over one full-width prefill
             of 8 x 2048 tokens and its decode steps: device time by kernel
             and the device's idle share.

The line before the last is the kernels' JSON record, the last line the
device record. Nothing is printed as a result without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# bf16 tolerance of the reference's own kernel tests (tests/test_kernels.py:28):
# o and lse are rounded or summed at other points in the two versions.
TOL_BF16 = 2e-2
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3
# the serve phase: requests, longest prompt, greedy steps
REQUESTS, MAX_PROMPT, DECODE_STEPS = 32, 2048, 16
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/flash_fwd.cu"
KERNEL_REPLACES = "src/repro/kernels/flash_attention.py:354"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ----------------------------------------------------------------------
# phase 1: device and build
# ----------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"[device] nvidia-smi: {smi_line}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; device 0: "
          f"{torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}, "
          f"{torch.cuda.device_count()} visible")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    took = time.perf_counter() - t0
    print(f"[device] built {sorted(built) or 'nothing (cached)'} in "
          f"{took:.1f}s with {_build.nvcc()}")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[device]   {name}: {line.strip()}")
    return smi_line


# ----------------------------------------------------------------------
# phase 2: K1 against its plain version
# ----------------------------------------------------------------------
def _cuda_time(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _case_inputs(torch, gen, *, b, t, s, h, kv, q_pos=None, kv_pos=None,
                 q_seg=None, kv_seg=None, q_scale=1.0):
    dev = "cuda"
    q = (torch.randn((b, t, h, 128), generator=gen, device=dev) * q_scale
         ).to(torch.bfloat16)
    k = torch.randn((b, s, kv, 128), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, 128), generator=gen, device=dev).to(torch.bfloat16)

    def ints(x, n):
        if x is None:
            x = torch.arange(n, dtype=torch.int32)[None].expand(b, n)
        return torch.as_tensor(x, dtype=torch.int32).to(dev).contiguous()

    qs = None if q_seg is None else ints(q_seg, t)
    ks = None if kv_seg is None else ints(kv_seg, s)
    return q, k, v, ints(q_pos, t), ints(kv_pos, s), qs, ks


def _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window):
    """(B, T, S) mask of the pairs the function needs, as the plain
    version builds it."""
    m = torch.ones((qpos.shape[0], qpos.shape[1], kpos.shape[1]),
                   dtype=torch.bool, device=qpos.device)
    d = qpos[:, :, None].long() - kpos[:, None, :].long()
    if causal:
        m &= d >= 0
        if window > 0:
            m &= d < window
    if qseg is not None:
        m &= (qseg[:, :, None] == kseg[:, None, :]) & (kseg[:, None, :] >= 0)
    return m


def _bound_ms(torch, q, k, qpos, kpos, qseg, kseg, causal, window):
    """Least time for the work these inputs need: FLOPs of the live pairs
    (q k^T and p v, 2 x 2 x D each) over the bf16 peak, against bytes of q,
    o, lse, the int inputs and the k/v rows some query can see over HBM."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    live = _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window)
    pairs = int(live.sum()) * h
    flops = 4.0 * d * pairs
    live_keys = int(live.any(dim=1).sum())            # (b, key) pairs read
    nbytes = (2 * b * t * h * d * 2                   # q in, o out
              + 2 * live_keys * kv * d * 2            # live k and v rows
              + b * h * t * 4                         # lse out
              + (b * t + b * s) * 4 * (2 if qseg is not None else 1))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _library_fn(torch, q, k, v, qpos, kpos, qseg, kseg, causal, window,
                softcap):
    """One PyTorch call computing the same attention, or None."""
    if softcap is not None:
        return None
    import torch.nn.functional as F
    b, t, h, d = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = {"enable_gqa": True} if h != k.shape[2] else {}
    causal_plain = (causal and window == 0 and qseg is None and t == k.shape[1]
                    and bool((qpos == kpos).all()))
    if causal_plain:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa)
    mask = _live_pairs(torch, qpos, kpos, qseg, kseg, causal, window)[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, **gqa)


def phase_kernel(torch):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    B_DEC, S_DEC, POS_DEC = 16, 2056, 1027
    # segmented rows: two samples then padding; the second row has a
    # sample, padding, and query rows whose every key is padding
    seg = [[0] * 100 + [1] * 120 + [-1] * 80, [2] * 50 + [-1] * 250]
    seg_pos = [list(range(100)) + list(range(120)) + [0] * 80,
               list(range(50)) + [0] * 250]
    cases = [
        ("prefill", dict(b=8, t=2048, s=2048, h=32, kv=32), {}, True),
        ("decode", dict(b=B_DEC, t=1, s=S_DEC, h=32, kv=32,
                        q_pos=[[POS_DEC]] * B_DEC), {}, True),
        ("gqa", dict(b=2, t=256, s=256, h=8, kv=2), {}, False),
        ("window", dict(b=2, t=512, s=512, h=4, kv=4), dict(window=128), False),
        ("softcap", dict(b=2, t=256, s=256, h=4, kv=2, q_scale=4.0),
         dict(softcap=3.0), False),
        ("segmented", dict(b=2, t=300, s=300, h=4, kv=2, q_pos=seg_pos,
                           kv_pos=seg_pos, q_seg=seg, kv_seg=seg), {}, False),
        ("segmented-noncausal", dict(b=2, t=300, s=300, h=4, kv=2, q_seg=seg,
                                     kv_seg=seg), dict(causal=False), False),
        ("ragged-700", dict(b=2, t=700, s=700, h=4, kv=4), {}, False),
        ("cross-noncausal", dict(b=2, t=130, s=200, h=4, kv=1),
         dict(causal=False), False),
    ]
    records, worst = {}, 0.0
    for name, shape, opts, timed in cases:
        opts = {"causal": True, "window": 0, "softcap": None, **opts}
        q, k, v, qp, kp, qs, ks = _case_inputs(torch, gen, **shape)
        args = (q, k, v, qp, kp, qs, ks)
        o, lse = fa.mha_forward(*args, **opts)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.mha_forward_plain(*args, **opts)
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
              f"K1 {name}: non-finite output")
        err_o = float((o.float() - o_ref.float()).abs().max())
        seen = lse_ref > -1e29                 # rows with a visible key
        err_l = float((lse - lse_ref)[seen].abs().max()) if seen.any() else 0.0
        check(bool((lse[~seen] <= -1e29).all()),
              f"K1 {name}: fully masked rows lost the -1e30 sentinel")
        check(bool((o[~seen.permute(0, 2, 1)] == 0).all()),
              f"K1 {name}: fully masked rows are not zero")
        worst = max(worst, err_o, err_l)
        line = (f"[kernel] {name:20s} q {tuple(q.shape)} k {tuple(k.shape)} "
                f"max|o-plain| {err_o:.3e} max|lse-plain| {err_l:.3e} "
                f"(tol {TOL_BF16}) masked rows {int((~seen).sum())}")
        check(err_o <= TOL_BF16 and err_l <= TOL_BF16,
              f"K1 {name}: disagrees with its plain version: {line}")
        if timed:
            iters = 20 if name == "prefill" else 100
            ms = _cuda_time(torch, lambda: fa.mha_forward(*args, **opts), iters)
            plain_ms = _cuda_time(
                torch, lambda: fa.mha_forward_plain(*args, **opts),
                max(3, iters // 10), warmup=1)
            lib = _library_fn(torch, *args, opts["causal"], opts["window"],
                              opts["softcap"])
            library_ms = _cuda_time(torch, lib, iters) if lib else None
            bound_ms, bound_by, flops, nbytes = _bound_ms(
                torch, q, k, qp, kp, qs, ks, opts["causal"], opts["window"])
            records[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms)
            line += (f"\n[kernel] {name:20s} kernel {ms:.4f} ms "
                     f"({flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
                     f"sdpa {library_ms if library_ms is None else round(library_ms, 4)} ms, "
                     f"bound {bound_ms:.4f} ms by {bound_by} "
                     f"({100 * bound_ms / ms:.1f}% of bound)")
        print(line, flush=True)
    return records, worst


# ----------------------------------------------------------------------
# phase 3: serve at full width
# ----------------------------------------------------------------------
def _serve(torch, n_layers, *, n_requests, max_prompt, decode_steps, seed):
    from repro_torch import serve as SV
    from repro_torch.models import model as MD
    cfg = SV.make_config("gpt-paper", "full", n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = MD.init_params(gen, cfg, device="cuda")
    tokens = SV.make_requests(cfg, n_requests, max_prompt)
    res = SV.serve(params, cfg, tokens, max_prompt=max_prompt,
                   decode_steps=decode_steps,
                   log=lambda m: print(f"[serve]{m}", flush=True))
    del params
    return cfg, tokens, res


def _compare_serves(torch, a, b, tol):
    """Max |logit difference| over the steps both runs fed the same tokens.
    A row stops being compared after the first step where the greedy
    tokens differ; there the top-2 gap must be within 2 x tol."""
    worst, compared = 0.0, 0
    for la, lb, ta, tb in zip(a.logits, b.logits, a.tokens, b.tokens):
        for row in range(la.shape[1]):
            for step in range(la.shape[0]):
                x, y = la[step, row], lb[step, row]
                d = float((x - y).abs().max())
                worst = max(worst, d / (1.0 + float(y.abs().max())))
                compared += 1
                if ta[row, step] != tb[row, step]:
                    top2 = torch.topk(y, 2).values
                    gap = float(top2[0] - top2[1])
                    check(gap <= 2 * tol, f"greedy tokens differ at row {row} "
                          f"step {step} with a top-2 gap of {gap:.3e}")
                    break
    return worst, compared


def phase_serve(torch, requests, max_prompt, decode_steps):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, tokens, res = _serve(torch, 32, n_requests=requests,
                              max_prompt=max_prompt,
                              decode_steps=decode_steps, seed=0)
    launches = ops.launch_counts()["mha_forward"]
    took = time.perf_counter() - t0
    import numpy as np
    from repro_torch.serve import report
    lens = np.array([len(t) for t in tokens])
    for line in report(res, lens).splitlines():
        print(f"[serve] {line}")
    nb = len(res.batches)
    expected = cfg.n_layers * (nb + nb * decode_steps)
    print(f"[serve] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"({cfg.n_params() / 1e9:.2f} B params), {len(tokens)} requests, "
          f"{decode_steps} decode steps in {took:.1f}s incl. init; "
          f"K1 launches {launches} (expected {expected}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    check(launches == expected, f"K1 launched {launches} times, "
          f"expected {expected}")
    finite = all(bool(torch.isfinite(x).all()) for x in res.logits)
    check(finite, "non-finite logits in the 32-layer serve")
    del res
    torch.cuda.empty_cache()

    # the same serve, 2 layers, once with K1 and once with the plain version
    kw = dict(n_requests=requests, max_prompt=max_prompt,
              decode_steps=decode_steps, seed=1)
    _, _, with_k1 = _serve(torch, 2, **kw)
    with mock.patch.object(fa, "_mha_forward_cuda",
                           lambda *a, **o: fa.mha_forward_plain(*a, **o)):
        _, _, with_plain = _serve(torch, 2, **kw)
    err, compared = _compare_serves(torch, with_k1, with_plain, TOL_BF16)
    print(f"[serve] 2 layers, K1 vs plain attention: max |logit diff| / "
          f"(1 + max|logit|) {err:.3e} over {compared} (row, step) logit "
          f"vectors (tol {TOL_BF16})", flush=True)
    check(err <= TOL_BF16, "2-layer serve logits: K1 and plain disagree")
    return launches


def _profile_window(torch, name, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the window's host time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    k1 = sum(r[0] for r in rows if "mha_fwd_kernel" in r[2])
    check(busy > 0, f"profile {name}: no device time recorded")
    print(f"[profile] {name}: host {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%)"
          f", K1 {k1:.1f} ms ({100 * k1 / busy:.1f}% of device time)")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<5d} "
              f"{key[:90]}")


def phase_profile(torch, max_prompt, decode_steps):
    """Where the time goes in the full-width serve: one prefill of the
    largest batch (8 x max_prompt) and its decode steps, after a warm-up."""
    from repro_torch import serve as SV
    from repro_torch.models import model as MD
    cfg = SV.make_config("gpt-paper", "full", 32)
    params = MD.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s = 8, max_prompt
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32),
             "positions": torch.arange(s, dtype=torch.int32, device="cuda")
             [None].expand(b, s).contiguous()}
    state = {}

    def prefill():
        logits, state["cache"] = MD.prefill(params, batch, cfg,
                                            cache_len=s + decode_steps)
        state["nxt"] = torch.argmax(logits, -1)[:, None].to(torch.int32)

    def decode():
        for step in range(decode_steps):
            pos = torch.full((b, 1), s + step, dtype=torch.int32, device="cuda")
            logits, state["cache"] = MD.decode(params, {
                "tokens": state["nxt"], "positions": pos,
                "cache": state["cache"], "cache_pos": s + step}, cfg)
            state["nxt"] = torch.argmax(logits, -1)[:, None].to(torch.int32)

    with torch.inference_mode():
        prefill()
        decode()          # warm-up of both
        _profile_window(torch, f"prefill {b}x{s}", prefill)
        _profile_window(torch, f"decode {decode_steps} steps of {b}", decode)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="device,kernel,serve",
                    help="comma-separated: kernel, serve, profile (the device "
                    "phase always runs)")
    args = ap.parse_args()
    phases = args.phases.split(",")

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        fail(f"the port is not in this checkout ({ROOT / 'src'})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi_line = phase_device(torch)
    records, worst, launches = {}, None, None
    if "kernel" in phases:
        records, worst = phase_kernel(torch)
    if "serve" in phases:
        launches = phase_serve(torch, REQUESTS, MAX_PROMPT, DECODE_STEPS)
    if "profile" in phases:
        phase_profile(torch, MAX_PROMPT, DECODE_STEPS)
    main_rec = records.get("prefill", {})
    kernels = [{
        "name": "K1 mha_forward", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst, "max_err": worst,
        "ms": main_rec.get("ms"), "plain_ms": main_rec.get("plain_ms"),
        "bound_ms": main_rec.get("bound_ms"),
        "bound_by": main_rec.get("bound_by"),
        "library_ms": main_rec.get("library_ms"),
        "decode": records.get("decode"),
    }]
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

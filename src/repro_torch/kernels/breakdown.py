"""Where the head-dim-256 attention backward's time goes, on the card.

Builds variants of a copy of ``flash_bwd.cu`` (given by path: this tree's
or an older checkout's) in ``build/breakdown/``, and times each with CUDA
events at gemma2-2b's shapes (its training rows, a local layer at 8192
tokens, and 256 queries over 40960 keys, where dq's ordered adds chain 640
key tiles) beside the unchanged source:

- ``as-is``: the source unchanged;
- ``no-dq-wait``: dq's adds kept, their wait on the ordering counter gone;
- ``no-dq-add``: dq's adds and their wait gone;
- ``s-dp-once`` (the mma.sync form only, which computes s and dp in both
  column-half warps of a key group): the second warp skips the products;
- ``stamps``: ``clock64()`` stamps between the phases of an item, summed
  per warp, so each phase's share of the warps' cycles.

Every variant but ``as-is`` computes a wrong dq, dk or dv: only their times
are read. The variants live only in the build directory; the sources of the
package are not changed. Run on a machine with a card and nvcc:

    python -m repro_torch.kernels.breakdown --source PATH/flash_bwd.cu \\
        --form mma|wgmma --out chiprun_out/breakdown.json
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

OUT_DIR = _build.BUILD_DIR.parent / "breakdown"
ITERS = 10   # timed launches per variant, after two to warm up

# a stamp: lane 0 of each warp adds the cycles since its last stamp to
# phase k of its warp's row, W the warp's index (0-7) in the stamped code
_STAMP = ("{ if ((threadIdx.x & 31) == 0) { const long long now_c = clock64(); "
          "cyc_s[W][%d] += now_c - prev_c; prev_c = now_c; } }\n")
_GLOBAL = """
__device__ unsigned long long g_cycles[8][8];
extern "C" int bwd_cycles(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
extern "C" int bwd_cycles_reset() {
  static const unsigned long long zeros[8][8] = {};
  return (int)cudaMemcpyToSymbol(g_cycles, zeros, sizeof(g_cycles));
}
"""
_INIT = ("__shared__ unsigned long long cyc_s[8][8];\n"
         "  if ((threadIdx.x & 31) == 0) for (int k_ = 0; k_ < 8; ++k_) "
         "cyc_s[W][k_] = 0;\n"
         "  long long prev_c = clock64();\n")
_FLUSH = ("  if ((threadIdx.x & 31) == 0) for (int k_ = 0; k_ < 8; ++k_) "
          "atomicAdd(&g_cycles[W][k_], cyc_s[W][k_]);\n")


def _stamp(k: int) -> str:
    return "    " + (_STAMP % k)


# per form: the phases the stamps separate, and the variants as lists of
# (anchor, replacement); "@N" in a replacement is stamp N
FORMS = {
    # PR 20's form, mha_bwd_d256_kernel on mma.sync: 8 warps over 64 keys
    "mma": {
        "warp": "(threadIdx.x / 32)",
        "phases": ["next item and its loads", "s and dp products", "p and ds",
                   "dv and dk products", "ds to shared memory", "dq product",
                   "dq counter wait", "dq adds"],
        "variants": {
            "no-dq-wait": [
                ("      if (lane == 0)\n        while (ld_acquire_gpu(sem) < before) __nanosleep(64);\n",
                 "")],
            "no-dq-add": [
                ("    // ---- dq's tile into the accumulator, after the live key tiles before",
                 "    __syncthreads();\n#if 0\n"),
                ("    if (tid == 0) red_release_gpu_add(sem, 1);\n",
                 "    if (tid == 0) red_release_gpu_add(sem, 1);\n#endif\n")],
            "s-dp-once": [
                ("#pragma unroll\n    for (int kk = 0; kk < kD / 16; ++kk) {\n"
                 "      uint32_t ka[4], va[4];",
                 "    if (col0 == 0) {\n#pragma unroll\n    for (int kk = 0; kk < kD / 16; ++kk) {\n"
                 "      uint32_t ka[4], va[4];"),
                ("\n    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2): element e of",
                 "    }\n\n    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2): element e of")],
            "stamps": [
                ("  const int n_qt = (p.T + kBQ - 1) / kBQ;\n  bool full = false, full_next = false;",
                 "@INIT  const int n_qt = (p.T + kBQ - 1) / kBQ;\n  bool full = false, full_next = false;"),
                ("    __syncthreads();   // k, v and this item's stage are in shared memory\n",
                 "    __syncthreads();   // k, v and this item's stage are in shared memory\n@0"),
                ("    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2): element e of",
                 "@1    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2): element e of"),
                ("    // ---- dv += p^T do, dk += ds^T q over the warp's 128 columns ----",
                 "@2    // ---- dv += p^T do, dk += ds^T q over the warp's 128 columns ----"),
                ("    // ---- ds^T to shared memory, [key][query row], by the warps of the",
                 "@3    // ---- ds^T to shared memory, [key][query row], by the warps of the"),
                ("    // ---- dq = ds k: query rows 16 kg.., columns col0.., over the 64 keys;",
                 "@4    // ---- dq = ds k: query rows 16 kg.., columns col0.., over the 64 keys;"),
                ("    // ---- dq's tile into the accumulator, after the live key tiles before",
                 "@5    // ---- dq's tile into the accumulator, after the live key tiles before"),
                ("    __syncthreads();   // the earlier key tiles' adds are complete\n",
                 "    __syncthreads();   // the earlier key tiles' adds are complete\n@6"),
                ("    if (tid == 0) red_release_gpu_add(sem, 1);\n",
                 "    if (tid == 0) red_release_gpu_add(sem, 1);\n@7"),
                ("  cp_async_wait<0>();   // k and v, where no item was live\n",
                 "@FLUSH  cp_async_wait<0>();   // k and v, where no item was live\n")],
        },
    },
    # the wgmma form, mha_bwd_d256_kernel: warps 0-3 of a block's consumers
    # are warpgroup 0, warps 4-7 warpgroup 1
    "wgmma": {
        "warp": "(threadIdx.x / 32 - 4)",
        "phases": ["wait for q and do", "s^T and dp^T products",
                   "p^T and ds^T, to shared memory", "wait for the other warpgroup",
                   "dv and dk products", "dq products", "dq slot wait", "dq store"],
        "variants": {
            "no-dq-wait": [
                ("          while (ld_acquire_gpu(sem) < 2 * it.w) __nanosleep(64);\n", "")],
            "no-dq-add": [
                ("          while (ld_acquire_gpu(sem) < 2 * it.w) __nanosleep(64);\n", ""),
                ("#pragma unroll\n        for (int x = 0; x < 2; ++x)\n"
                 "          tma_reduce_add_4d(tdq, src + x * L::kDQBox, 128 * w + 64 * qt + 32 * x,\n"
                 "                            it.x, it.y, b);\n", "")],
            "stamps": [
                ("  mbar_wait(bar.kv, 0);\n  uint32_t phase = 0;\n  for (;;) {",
                 "  mbar_wait(bar.kv, 0);\n@INIT  uint32_t phase = 0;\n  for (;;) {"),
                ("    mbar_wait(bar.do_full, phase);\n\n    // ---- s^T = k q^T and dp^T",
                 "    mbar_wait(bar.do_full, phase);\n@0\n    // ---- s^T = k q^T and dp^T"),
                ("    fence_regs(dp);\n\n    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2), in one of\n"
                 "    // four forms, to shared memory",
                 "    fence_regs(dp);\n@1\n    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2), in one of\n"
                 "    // four forms, to shared memory"),
                ("    named_barrier(2, kConsumers);   // both are done with the last p^T and ds^T\n",
                 "@2    named_barrier(2, kConsumers);   // both are done with the last p^T and ds^T\n@3"),
                ("    named_barrier(1, kConsumers);   // both warpgroups' rows are written\n",
                 "@2    named_barrier(1, kConsumers);   // both warpgroups' rows are written\n@3"),
                ("    wgmma_wait<0>();   // dk's\n",
                 "    wgmma_wait<0>();   // dk's\n@4"),
                ("      fence_regs(dqa);\n      mbar_wait(bar.dq_empty + 8 * slot, phase ^ 1);\n",
                 "      fence_regs(dqa);\n@5      mbar_wait(bar.dq_empty + 8 * slot, phase ^ 1);\n@6"),
                ("      if (lane == 0) mbar_arrive(bar.dq_full + 8 * slot);\n    }\n    phase ^= 1;\n",
                 "      if (lane == 0) mbar_arrive(bar.dq_full + 8 * slot);\n@7    }\n    phase ^= 1;\n"),
                ("  // the end of this warpgroup's add_dq256 loop, in its first slot\n",
                 "@FLUSH  // the end of this warpgroup's add_dq256 loop, in its first slot\n")],
        },
    },
}


def variant_source(src: str, form: str, name: str) -> str:
    """The text of variant `name` of the source `src` of form `form`."""
    if name == "as-is":
        return src
    for anchor, repl in FORMS[form]["variants"][name]:
        if src.count(anchor) != 1:
            raise ValueError(f"{form}/{name}: anchor found {src.count(anchor)} "
                             f"times: {anchor[:70]!r}")
        repl = repl.replace("@INIT", _INIT).replace("@FLUSH", _FLUSH)
        for k in range(8):
            repl = repl.replace(f"@{k}", _stamp(k))
        repl = repl.replace("[W]", f"[{FORMS[form]['warp']}]")
        src = src.replace(anchor, repl)
    if name == "stamps":
        src = src.replace("namespace {\n", _GLOBAL + "\nnamespace {\n", 1)
    return src


def build_variants(source: Path, form: str, names, tag: str) -> dict[str, ctypes.CDLL]:
    """The variants `names` of `source`, compiled together, one nvcc each,
    under build/breakdown/<tag>/."""
    text = source.read_text()
    procs = {}
    for name in names:
        d = OUT_DIR / tag / name
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for header in source.parent.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "flash_bwd.cu").write_text(variant_source(text, form, name))
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "flash_bwd.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {form}/{name}:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(OUT_DIR / tag / name / "lib.so"))
        lib.mha_bwd_bf16.argtypes = _build.KERNELS["flash_bwd"][1]["mha_bwd_bf16"]
        lib.mha_bwd_bf16.restype = ctypes.c_int
        libs[name] = lib
        print(f"[breakdown] {form}/{name}: built; ptxas, last kernel: "
              f"{regs[-2:] if regs else '-'}", flush=True)
    return libs


def _inputs(case: str, gen):
    """gemma2-2b's attention at head dim 256 (softcap 50), as
    ``chip_smoke.py``'s kernel phase has it: `train`, 8 q and 4 kv heads
    over its gemma2-train rows (B 4, samples of 2048, 1500, 900 and 300
    tokens, then padding); `local-8k`, B 2, T = S = 8192 under the
    4096-token window; `keys-40960`, B 1, 2 q heads and 1 kv head, the last
    256 of 40960 positions."""
    dev = "cuda"
    h, kv, s = 8, 4, None
    if case == "keys-40960":
        b, t, s, h, kv, window = 1, 256, 40960, 2, 1, 0
        seg = None
        pos = torch.arange(s - t, s, dtype=torch.int32, device=dev)[None].contiguous()
        kpos = torch.arange(s, dtype=torch.int32, device=dev)[None].contiguous()
    elif case == "train":
        b, t, window = 4, 2048, 0
        seg = torch.full((b, t), -1, dtype=torch.int32)
        pos = torch.zeros((b, t), dtype=torch.int32)
        for r, n in enumerate((2048, 1500, 900, 300)):
            seg[r, :n] = 0
            pos[r, :n] = torch.arange(n)
        seg, pos = seg.to(dev), pos.to(dev)
    else:
        b, t, window = 2, 8192, 4096
        seg = None
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t).contiguous()
    if s is None:
        s, kpos = t, pos
    q = torch.randn((b, t, h, 256), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kv, 256), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, 256), generator=gen, device=dev).to(torch.bfloat16)
    opts = dict(causal=True, window=window, softcap=50.0)
    return (q, k, v, pos, kpos, seg, seg), opts


def _time(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True, type=Path)
    ap.add_argument("--form", required=True, choices=sorted(FORMS))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--variants", default=None,
                    help="comma-separated (default: as-is and every variant "
                    "of the form)")
    ap.add_argument("--tag", default=None,
                    help="the build directory's name (default: the form)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    names = (args.variants.split(",") if args.variants
             else ["as-is", *FORMS[args.form]["variants"]])
    libs = build_variants(args.source, args.form, names, args.tag or args.form)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "form": args.form,
              "source": str(args.source), "cases": {}}
    for case in ("train", "local-8k", "keys-40960"):
        (q, k, v, qp, kp, qs, ks), opts = _inputs(case, gen)
        o, lse = fa.mha_forward_plain(q, k, v, qp, kp, qs, ks, **opts)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
        delta = fa.attention_delta(o, do)
        acc, sem = fa.dq_accumulator(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        b, t, h, d = q.shape
        sems = torch.zeros((ITERS + 3,) + sem.shape, dtype=torch.int32,
                           device="cuda")
        ptr = lambda x: None if x is None else x.data_ptr()
        rec = {}
        for name, lib in libs.items():
            it = iter(sems.zero_())

            def call(lib=lib):
                _build.launch(lib.mha_bwd_bf16, ptr(q), ptr(k), ptr(v), ptr(do),
                              ptr(lse), ptr(delta), ptr(qp), ptr(kp), ptr(qs),
                              ptr(ks), ptr(acc), acc.shape[2], ptr(next(it)),
                              ptr(dk), ptr(dv), b, t, k.shape[1], h, k.shape[2],
                              d, 1, opts["window"], opts["softcap"],
                              fa.softmax_scale(d), device=q.device)
            if name == "stamps":
                lib.bwd_cycles_reset()
                call()
                torch.cuda.synchronize()
                cyc = (ctypes.c_ulonglong * 64)()
                lib.bwd_cycles(ctypes.byref(cyc))
                per = [[cyc[w * 8 + i] for i in range(8)] for w in range(8)]
                tot = sum(map(sum, per)) or 1
                phases = FORMS[args.form]["phases"]
                share = {ph: sum(row[i] for row in per) / tot
                         for i, ph in enumerate(phases)}
                rec["stamps_share"] = share
                # mma: the column halves' warps; wgmma: warpgroups 0 and 1
                rec["stamps_share_by_warp_half"] = [
                    {ph: sum(row[i] for row in per[4 * w:4 * w + 4])
                         / max(1, sum(map(sum, per[4 * w:4 * w + 4])))
                     for i, ph in enumerate(phases)} for w in range(2)]
                print(f"[breakdown] {args.form} {case}: stamps, share of warp "
                      "cycles: " + ", ".join(f"{k} {100 * x:.1f}%"
                                             for k, x in share.items()), flush=True)
                for w, sh in enumerate(rec["stamps_share_by_warp_half"]):
                    print(f"[breakdown] {args.form} {case}:   warps {4 * w}-{4 * w + 3}: "
                          + ", ".join(f"{k} {100 * x:.1f}%" for k, x in sh.items()),
                          flush=True)
            it = iter(sems.zero_())
            rec[name] = _time(call, ITERS)
            print(f"[breakdown] {args.form} {case}: {name} {rec[name]:.4f} ms",
                  flush=True)
        result["cases"][case] = rec
        del q, k, v, o, do, acc, sem, dk, dv, sems
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

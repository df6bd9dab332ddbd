"""Where a kernel's time goes, on the card.

Builds variants of a copy of a kernel source (given by path: this tree's
or an older checkout's) in ``build/breakdown/``, and times each with CUDA
events beside the unchanged source. Three kernels, each in the forms its
sources have had:

- the head-dim-256 backward (``flash_bwd.cu``; ``--form mma`` for its
  mma.sync source, ``wgmma`` for this tree's), at gemma2-2b's shapes: its
  training rows, a local layer at 8192 tokens, and 256 queries over 40960
  keys, where dq's ordered adds chain 640 key tiles. Variants:
  ``no-dq-wait`` (dq's adds kept, their wait on the ordering counter
  gone), ``no-dq-add`` (dq's adds and their wait gone), ``s-dp-once`` (the
  mma.sync form only, which computes s and dp in both column-half warps of
  a key group: the second warp skips the products);
- K1's decode form, T = 1 (``flash_fwd.cu``; ``--form decode-mma`` for the
  form before the cache split, one block per (16 query rows, q head, batch
  row); ``decode`` for this tree's, one block per (cache split, KV head,
  batch row)), at the serve paths' decode shapes: ``decode`` (gpt-paper,
  B 16, S 2056 at position 1027), ``gemma2-decode`` (B 16, S 8200 at 8199,
  window 4096), ``gemma2-serve-decode`` (B 8, S 2064 at 2063),
  ``granite-decode`` (B 8, S 2064 at 2063, 24 q / 8 kv heads x 64) and
  ``llava-decode`` (B 4, S 3400 at 3399, 56 / 8 x 128). Each launch is
  timed on the stream after 1 GiB is written to flush L2, as the serve
  path finds each layer's cache cold; torch.profiler gives its device
  time by kernel too. ``--split-scales`` also times this tree's form at
  other multiples of the plan's splits;
- K4's backward (``ssd_bwd.cu``, ``--form ssd-bwd``: the dS' walk, then the
  chunk pass), at mamba2-130m's training shapes, ``ssd-train`` (B 8, T
  2048, 24 heads x 64, N 128) and ``ssd-train-192`` (T 192), and at
  jamba's head shape, ``ssd-bwd-p128`` (B 2, T 2048, 8 heads x 128, N
  128), from K4's chunk-start states and a random d_final, each pass
  timed by CUDA events too. Variants: ``generic-bounds`` (the launchers
  never take the instantiations for whole shapes, whose loop bounds are
  constants) and ``one-staging-tile`` (the walk waits for its last store
  before it writes the next, as with one staging tile a warp), both with
  the same outputs; ``no-walk-store`` and ``no-state-products`` (the chunk
  pass without B dS'ᵀ, dy S and x dS') time the parts they leave out.

Every form also has ``stamps``: ``clock64()`` stamps between the phases of
its loop, summed per warp, so each phase's share of the warps' cycles.
This tree's decode form also has other plans (``stages2``, ``stages4``,
``bn32``, ``bn64``: the ring's depth, the keys a stage), which compute the
same outputs; every other variant but ``as-is`` computes wrong ones, and
only its time is read. The variants live only in the build directory; the
sources of the package are not changed. Run on a machine with a card and
nvcc:

    python -m repro_torch.kernels.breakdown --source PATH/flash_bwd.cu \\
        --form mma|wgmma|decode-mma|decode|ssd-bwd --out breakdown.json
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

OUT_DIR = _build.BUILD_DIR.parent / "breakdown"
ITERS = 10   # timed launches per variant, after two to warm up
DECODE_ITERS = 50   # the same for K1's decode forms

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


# per form: its source file, the phases the stamps separate, and the
# variants as lists of (anchor, replacement); "@N" in a replacement is
# stamp N
FORMS = {
    # PR 20's form, mha_bwd_d256_kernel on mma.sync: 8 warps over 64 keys
    "mma": {
        "file": "flash_bwd.cu",
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
        "file": "flash_bwd.cu",
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
    # K1's decode form before the cache split, mha_fwd_decode_kernel<kD>: 4
    # warps, one block per (16 query rows, q head, batch row), a block
    # barrier per key tile in the tile search, one tile loading behind the
    # one computed
    "decode-mma": {
        "file": "flash_fwd.cu",
        "warp": "(threadIdx.x / 32)",
        "phases": ["tile search", "load issue and wait", "s = q k^T",
                   "softmax", "o += p v", "tile barrier",
                   "row sums and warp merge"],
        "variants": {
            "stamps": [
                ("  // ---- this thread's two query rows, and the q tile's statistics ----\n",
                 "@INIT  // ---- this thread's two query rows, and the q tile's statistics ----\n"),
                ("  int cur = find_live(0, 0, full);\n",
                 "  int cur = find_live(0, 0, full);\n@0"),
                ("    const int next = find_live(cur + 1, buf ^ 1, full_next);\n",
                 "    const int next = find_live(cur + 1, buf ^ 1, full_next);\n@0"),
                ("    __syncthreads();   // tile cur is in buffer buf for every thread\n",
                 "    __syncthreads();   // tile cur is in buffer buf for every thread\n@1"),
                ("      // ---- scale (to log2), cap, mask; online softmax update ----",
                 "@2      // ---- scale (to log2), cap, mask; online softmax update ----"),
                ("      // ---- o += p v: p from the s fragments, v by transposed ldmatrix ----",
                 "@3      // ---- o += p v: p from the s fragments, v by transposed ldmatrix ----"),
                ("    __syncthreads();   // buffer buf is free for the tile after next\n",
                 "@4    __syncthreads();   // buffer buf is free for the tile after next\n@5"),
                ("  if (warp > 0) return;\n", "@6@FLUSH  if (warp > 0) return;\n")],
        },
    },
    # this tree's decode form, mha_fwd_decode_kernel<kD, kMT>: 4 warps, one
    # block per (cache split, KV head, batch row), a ring of 3 stages
    "decode": {
        "file": "flash_fwd.cu",
        "warp": "(threadIdx.x / 32)",
        "phases": ["q and the tile search", "load wait", "next stage's issue",
                   "s = q k^T", "scale, mask, row max and barrier",
                   "p to shared memory and barrier", "o += p v",
                   "row sums, out and the splits' merge"],
        "variants": {
            # other plans, each computing the same outputs: a ring of 2 or
            # 4 stages; 32 keys a stage from D 128 (smaller stages, more
            # blocks an SM), or 64 at D 256 too (one block an SM)
            "stages2": [("constexpr int kDecStages = 3;", "constexpr int kDecStages = 2;")],
            "stages4": [("constexpr int kDecStages = 3;", "constexpr int kDecStages = 4;")],
            "bn32": [("  static constexpr int kBN = kD > 128 ? 32 : 64;",
                      "  static constexpr int kBN = kD >= 128 ? 32 : 64;")],
            "bn64": [("  static constexpr int kBN = kD > 128 ? 32 : 64;",
                      "  static constexpr int kBN = 64;")],
            "stamps": [
                ("  // ---- this thread's rows (g and g + 8 of each row tile) and their mask:\n",
                 "@INIT  // ---- this thread's rows (g and g + 8 of each row tile) and their mask:\n"),
                ("  const int n_st = (rank1 - rank0) * L::kSub;   // stages this block computes\n",
                 "  const int n_st = (rank1 - rank0) * L::kSub;   // stages this block computes\n@0"),
                ("    __syncthreads();   // stage j is in shared memory; stage j - 1 is free\n",
                 "    __syncthreads();   // stage j is in shared memory; stage j - 1 is free\n@1"),
                ("    // ---- s = q k^T: every row tile x this warp's kBN / 4 keys ----\n",
                 "@2    // ---- s = q k^T: every row tile x this warp's kBN / 4 keys ----\n"),
                ("    // ---- to the log2 domain (and capped), masked; the warp's row maxima ----\n",
                 "@3    // ---- to the log2 domain (and capped), masked; the warp's row maxima ----\n"),
                ("    __syncthreads();   // every warp's row maxima\n",
                 "    __syncthreads();   // every warp's row maxima\n@4"),
                ("    __syncthreads();   // p of the whole stage\n",
                 "    __syncthreads();   // p of the whole stage\n@5"),
                ("    }\n  }\n  cp_async_wait<0>();   // the empty groups of the ring's tail\n",
                 "    }\n@6  }\n  cp_async_wait<0>();   // the empty groups of the ring's tail\n"),
                ("      if (tid == 0) *count = 0;   // for the workspace's next use\n    }\n  }\n}\n",
                 "      if (tid == 0) *count = 0;   // for the workspace's next use\n    }\n  }\n@7@FLUSH}\n")],
        },
    },
    # this tree's K4 backward: its two passes; variants of its design
    # choices (the same outputs) and two that leave a part out
    "ssd-bwd": {
        "file": "ssd_bwd.cu",
        "warp": "(threadIdx.x / 32)",
        "phases": [],
        "variants": {
            "generic-bounds": [
                ("  if (p.N % kCols1 == 0 && p.P == kP) {", "  if (false) {"),
                ("  if (p.N == 128 && p.P == kP) {", "  if (false) {")],
            "one-staging-tile": [
                ('  asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");',
                 '  asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");')],
            "no-walk-store": [
                ("    {\n      unsigned char* const stg = stg0 + warp * Ly::kStg",
                 "    if (false) {\n      unsigned char* const stg = stg0 + warp * Ly::kStg")],
            "no-state-products": [
                ("      if (y_warp) {\n        for (int kk = 0; kk < n16; ++kk) {",
                 "      if (false) {\n        for (int kk = 0; kk < n16; ++kk) {"),
                ("      {\n        const int kmax = kWhole",
                 "      if (false) {\n        const int kmax = kWhole")],
        },
    },
}
# the C entry of each source file, and its argument types
ENTRY = {"flash_bwd.cu": "mha_bwd_bf16", "flash_fwd.cu": "mha_fwd_bf16",
         "ssd_bwd.cu": "ssd_bwd_bf16"}
ARGTYPES = {
    "mma": _build.KERNELS["flash_bwd"][1]["mha_bwd_bf16"],
    "wgmma": _build.KERNELS["flash_bwd"][1]["mha_bwd_bf16"],
    # the entry before this tree's decode form: no workspace, splits or
    # heads per block
    "decode-mma": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                  + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "decode": _build.KERNELS["flash_fwd"][1]["mha_fwd_bf16"],
    "ssd-bwd": _build.KERNELS["ssd_bwd"][1]["ssd_bwd_bf16"],
}
# K4's backward: name -> (B, T, H, P, N), one group
SSD_BWD_CASES = {"ssd-train": (8, 2048, 24, 64, 128),
                 "ssd-train-192": (8, 192, 24, 64, 128),
                 "ssd-bwd-p128": (2, 2048, 8, 128, 128)}
DECODE_CASES = ("decode", "gemma2-decode", "gemma2-serve-decode",
                "granite-decode", "llava-decode")


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
    under build/breakdown/<tag>/; a variant whose source and headers are
    those of its last build there is loaded as it is."""
    text = source.read_text()
    file = FORMS[form]["file"]
    procs = {}
    for name in names:
        d = OUT_DIR / tag / name
        files = {file: variant_source(text, form, name)}
        files.update({h.name: h.read_text() for h in source.parent.glob("*.cuh")})
        if (d / "lib.so").exists() and all(
                (d / f).exists() and (d / f).read_text() == t
                for f, t in files.items()):
            procs[name] = None
            continue
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for f, t in files.items():
            (d / f).write_text(t)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / file)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log_file = OUT_DIR / tag / name / "nvcc.log"
        if proc is None:   # built before
            log = log_file.read_text() if log_file.exists() else ""
        else:
            log, _ = proc.communicate()
            log_file.write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {form}/{name}:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(OUT_DIR / tag / name / "lib.so"))
        entry = getattr(lib, ENTRY[file])
        entry.argtypes = ARGTYPES[form]
        entry.restype = ctypes.c_int
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


# K1's decode cases: (b, s, query position, h, kv, d, window, softcap), as
# chip_smoke.py's kernel phase has them
DECODE_SHAPES = {
    "decode": (16, 2056, 1027, 32, 32, 128, 0, None),
    "gemma2-decode": (16, 8200, 8199, 8, 4, 256, 4096, 50.0),
    "gemma2-serve-decode": (8, 2064, 2063, 8, 4, 256, 4096, 50.0),
    "granite-decode": (8, 2064, 2063, 24, 8, 64, 0, None),
    "llava-decode": (4, 3400, 3399, 56, 8, 128, 0, None),
}


def _decode_call(form, lib, case, gen, split_scale=1.0):
    """(launch, check): one launch of form `form`'s entry in `lib` at
    decode case `case` (this tree's form with `split_scale` times the
    plan's splits), and the largest |o - plain| of its outputs."""
    b, s, pos, h, kv, d, window, softcap = DECODE_SHAPES[case]
    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(torch.bfloat16)
    qp = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    kp = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, 1), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    common = (ptr(q), ptr(k), ptr(v), ptr(qp), ptr(kp), None, None, ptr(o),
              ptr(lse))
    shape = (b, 1, s, h, kv, d, 1, window, float(softcap or 0.0),
             fa.softmax_scale(d))
    if form == "decode-mma":
        args = common + shape
    else:
        gh, n_split = fa.decode_plan(b, 1, h, kv, s, d, fa.sm_count(q.device))
        n_split = max(1, round(n_split * split_scale))
        need = fa.decode_workspace_numel(n_split, b, 1, h, kv, d, gh)
        ws = torch.zeros(max(need, 1), dtype=torch.float32, device=dev)
        args = (common + (ptr(ws) if need else None,) + shape
                + (n_split, gh, need, 0))
    fn = lib.mha_fwd_bf16

    def launch():   # this tree's form: the workspace zeroed, as the wrapper does
        if form == "decode" and need:
            ws.zero_()
        _build.launch(fn, *args, device=q.device)

    def check():
        ref = fa.mha_forward_plain(q, k, v, qp, kp, causal=True,
                                   window=window, softcap=softcap)[0]
        return float((o.float() - ref.float()).abs().max())
    launch.keep = (q, k, v, qp, kp, o, lse) + (() if form == "decode-mma" else (ws,))
    return launch, check


def _cold_ms(fn, flush, iters):
    """Each call's time on the stream, CUDA events around it, with `flush`
    written before it."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def _device_ms(fn, iters):
    """Device time per call of `fn` by kernel name (torch.profiler), for the
    kernels of K1."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "mha_fwd" in e.key:
            name = re.search(r"mha_fwd_\w+", e.key).group(0)
            out[name] = (out.get(name, 0.0)
                         + getattr(e, "self_device_time_total", 0) / 1e3 / iters)
    return out


def _stamp_shares(lib, fn, form):
    """Each phase's share of the stamped warps' cycles over one call."""
    lib.bwd_cycles_reset()
    fn()
    torch.cuda.synchronize()
    cyc = (ctypes.c_ulonglong * 64)()
    lib.bwd_cycles(ctypes.byref(cyc))
    per = [[cyc[w * 8 + i] for i in range(8)] for w in range(8)]
    tot = sum(map(sum, per)) or 1
    phases = FORMS[form]["phases"]
    return per, {ph: sum(row[i] for row in per) / tot
                 for i, ph in enumerate(phases)}


def decode_main(args, libs) -> dict:
    """K1's decode forms: each variant's time per case, its kernels' device
    time, and the stamps' shares."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    # 1 GiB written before each timed launch: 20 times the L2, and longer
    # on the card than a launch's host path
    flush = torch.empty(1 << 28, device="cuda")
    cases = {}
    for case in DECODE_SHAPES:
        rec = {}
        for name, lib in libs.items():
            launch, check = _decode_call(args.form, lib, case, gen)
            if name == "stamps":
                _, share = _stamp_shares(lib, launch, args.form)
                rec["stamps_share"] = share
                print(f"[breakdown] {args.form} {case}: stamps, share of warp "
                      "cycles: " + ", ".join(f"{k} {100 * x:.1f}%"
                                             for k, x in share.items()), flush=True)
                continue
            launch()
            torch.cuda.synchronize()
            err = check()
            rec[name] = _cold_ms(launch, flush, DECODE_ITERS)

            def cold():   # the serve path finds each layer's cache cold
                flush.zero_()
                launch()
            rec[name + " device"] = _device_ms(cold, DECODE_ITERS)
            rec[name + " max_abs_err"] = err
            print(f"[breakdown] {args.form} {case}: {name} {rec[name]:.4f} ms "
                  "(each launch after a flush of L2); profiler: " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in rec[name + " device"].items())
                  + f"; max |o - plain| {err:.3e}", flush=True)
            del launch
        for scale in args.split_scales if "as-is" in libs else ():
            launch, check = _decode_call(args.form, libs["as-is"], case, gen, scale)
            launch()
            torch.cuda.synchronize()
            key = f"as-is, splits x{scale}"
            rec[key] = _cold_ms(launch, flush, DECODE_ITERS)
            rec[key + " max_abs_err"] = check()
            print(f"[breakdown] {args.form} {case}: {key} {rec[key]:.4f} ms; max "
                  f"|o - plain| {rec[key + ' max_abs_err']:.3e}", flush=True)
            del launch
        cases[case] = rec
        torch.cuda.empty_cache()
    return cases


def ssd_bwd_pass_ms(args, dy, starts, d_final, iters):
    """Each pass of K4's backward, by CUDA events recorded before, between
    and after its two passes, averaged over ``iters`` calls after two to
    warm up: ``(the walk's ms, the chunk pass's ms)``."""
    from repro_torch.kernels import ssd as SSD
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(iters + 2)]
    for e in ev:
        SSD._ssd_bwd_cuda(*args, dy, starts, d_final, pass_events=e)
    torch.cuda.synchronize()
    return (sum(e[0].elapsed_time(e[1]) for e in ev[2:]) / iters,
            sum(e[1].elapsed_time(e[2]) for e in ev[2:]) / iters)


def ssd_bwd_main(libs) -> dict:
    """K4's backward: each variant's time per case through the wrapper
    (``ssd._ssd_bwd_cuda``, the variant's library in place of the built
    one), each pass's by CUDA events, and the worst error against the plain
    walk per 64-step chunk (as ``chip_smoke.py`` reads it)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as SSD
    gen = torch.Generator(device="cuda").manual_seed(3)
    built = _build.library
    cases = {}
    for case, (b, t, h, p, n) in SSD_BWD_CASES.items():
        u = torch.randn((b, t, h * p + 2 * n), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        x = u[..., :h * p].reshape(b, t, h, p)
        B = u[..., h * p:h * p + n].reshape(b, t, 1, n)
        C = u[..., h * p + n:].reshape(b, t, 1, n)
        dt = torch.nn.functional.softplus(
            torch.randn((b, t, h), generator=gen, device="cuda"))
        A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
        dy = torch.randn((b, t, h, p), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
        d_final = torch.randn((b, h, p, n), generator=gen, device="cuda")
        args = (x, dt, A, B, C)
        _, _, raw = SSD._ssd_launch(*args, None, True)
        want = ref.ssd_chunked_bwd(*args, dy, ref.ssd_chunk_parallel(*args)[2],
                                   d_final=d_final)
        rec = {}
        for name, lib in libs.items():
            _build.library = lambda kernel, lib=lib: (
                lib if kernel == "ssd_bwd" else built(kernel))
            try:
                got = SSD._ssd_bwd_cuda(*args, dy, raw, d_final)
                err = max(_chunk_rel(o, w) for o, w in zip(got, want)
                          if o.dim() > 1 and o.shape[1] == t)
                del got
                ms = _time(lambda: SSD._ssd_bwd_cuda(*args, dy, raw, d_final),
                           ITERS)
                walk, chunk = ssd_bwd_pass_ms(args, dy, raw, d_final, ITERS)
            finally:
                _build.library = built
            rec[name] = {"ms": ms, "walk_ms": walk, "chunk_pass_ms": chunk,
                         "worst_chunk_rel": err}
            print(f"[breakdown] ssd-bwd {case}: {name} {ms:.4f} ms (by CUDA "
                  f"events, the walk {walk:.4f}, the chunk pass {chunk:.4f}); "
                  f"worst relative error per 64-step chunk {err:.3e}",
                  flush=True)
        cases[case] = rec
        del u, x, dt, A, B, C, dy, d_final, raw, want, args
        torch.cuda.empty_cache()
    return cases


def _chunk_rel(out, ref, chunk=64):
    """Worst ||out - ref|| / ||ref|| over (batch row, 64-step chunk) of a
    (B, T, ...) gradient."""
    o, r = out.float(), ref.float()
    b, t = o.shape[:2]
    nc = -(-t // chunk)
    pad = (0, 0) * (o.dim() - 2) + (0, nc * chunk - t)
    o = torch.nn.functional.pad(o, pad).reshape(b, nc, -1)
    r = torch.nn.functional.pad(r, pad).reshape(b, nc, -1)
    rn = r.norm(dim=2)
    return float(((o - r).norm(dim=2) / rn.clamp_min(1e-30)).max())


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
    ap.add_argument("--split-scales", default="",
                    type=lambda x: [float(v) for v in x.split(",") if v],
                    help="the decode form only: also time as-is with these "
                    "multiples of the plan's splits (comma-separated)")
    ap.add_argument("--tag", default=None,
                    help="the build directory's name (default: the form)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    names = (args.variants.split(",") if args.variants
             else ["as-is", *FORMS[args.form]["variants"]])
    libs = build_variants(args.source, args.form, names, args.tag or args.form)
    result = {"device": torch.cuda.get_device_name(0), "form": args.form,
              "source": str(args.source), "cases": {}}
    if FORMS[args.form]["file"] in ("flash_fwd.cu", "ssd_bwd.cu"):
        result["cases"] = (decode_main(args, libs)
                           if args.form.startswith("decode")
                           else ssd_bwd_main(libs))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(result, indent=1))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
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
                per, share = _stamp_shares(lib, call, args.form)
                phases = FORMS[args.form]["phases"]
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

"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). Libraries
go to ``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source builds anew and an unchanged one is loaded as it is.
Nothing is built when the module is imported: :func:`library` builds at the
first launch. Nothing links against the driver library: the TMA tensor maps
of K1's prefill form and of the backward are encoded with
``cuTensorMapEncodeTiled``, reached at run time through the runtime's
``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> (source file, {C function: argtypes}); every function returns int
KERNELS = {
    "flash_fwd": ("flash_fwd.cu", {
        "mha_fwd_bf16": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
        "mha_fwd_prefill_smem": [_I],
    }),
    "flash_bwd": ("flash_bwd.cu", {
        "mha_bwd_bf16": [_P] * 11 + [_I, _P, _P, _P] + [_I] * 8
                        + [ctypes.c_float, _P],
    }),
    "ssd_fwd": ("ssd_fwd.cu", {
        "ssd_fwd_bf16": [_P] * 8 + [_I] * 6 + [_L] * 12 + [_P],
    }),
    # K4's first, serial form: a yardstick chip_smoke.py times, on no path
    "ssd_fwd_serial": ("ssd_fwd_serial.cu", {
        "ssd_fwd_serial_bf16": [_P] * 7 + [_I] * 6 + [_L] * 12 + [_P],
    }),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns seconds per
    name built; writes each compiler log beside its library."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took, failed = {}, []
    for name, (proc, tmp, out) in procs.items():   # wait for every nvcc
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        took[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def launch(fn, *args, device):
    """Call a C launcher on ``device``'s current stream; raise on its code."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def build_log(name: str) -> str:
    """The compiler's output for kernel ``name`` (registers, spills)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""

"""Format-2 checkpoints of the port's training state.

Counterpart of ``repro.train.checkpoint``, writing the same on-disk format,
so either package loads what the other wrote: one ``.npy`` per leaf, named
by its ``/``-joined path with ``/`` replaced by ``__``, and a
``manifest.json`` holding ``format: 2``, ``step``, ``time``, ``extra`` and,
per leaf path, its file, shape, dtype name and the CRC32 of exactly the
bytes written. Paths join dict keys in sorted order, as ``jax.tree`` does.
bf16 leaves are stored as their ``uint16`` bits under dtype
``"bfloat16"`` (numpy has no bfloat16, and the port no ``ml_dtypes``); a
Python ``int`` leaf, the optimizer's ``step``, as a 0-d ``int32`` array
(the reference's own ``step`` is one) and is read back as an ``int``.

Writes are atomic (a ``.tmp-{step}-{pid}-{uuid8}`` directory, then a
rename) and keep a rolling window of ``keep`` steps; ``save`` first sweeps
the tmp directories of writers that died. ``load`` verifies every CRC and
raises :class:`CheckpointCorruptError` on a torn or bit-flipped step;
:func:`load_latest_valid` walks back past such steps to the newest one
that restores.

The state lives on the card and is updated in place (``adamw_update``,
``tree.add_into``), so both directions work leaf by leaf:

- :func:`save` synchronises every device the leaves lie on (each stage's
  stream included) and copies one leaf at a time to the host: host memory
  stays bounded by the largest leaf, not the state.
- :func:`load` copies each verified leaf into the live tensor of
  ``tree_like`` (``copy_``), allocating no second tree on the card; the
  tensors keep their identity, so whatever holds them (the stage
  pipeline's ``set_params``) sees the restored values.

A leaf the mesh backend split by ZeRO-1 (a
:class:`~repro_torch.dist.sharding.ZeroShards`) is written whole, its
chunks gathered on the host, and restored by scattering the whole value
back into its chunks: the files do not depend on the placement.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid
import warnings
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import ZeroShards
from repro_torch.tree import flatten, unflatten


class CheckpointCorruptError(RuntimeError):
    """Checkpoint exists but fails structural or checksum validation."""


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, ZeroShards))


def _cuda_indices(leaves) -> list[int]:
    """The CUDA devices the leaves (or their chunks) lie on."""
    devs = set()
    for x in leaves:
        if isinstance(x, torch.Tensor):
            devs.add(x.device)
        elif isinstance(x, ZeroShards):
            devs.update(x.devices)
    return sorted({d.index or 0 for d in devs if d.type == "cuda"})


def _dtype_name(leaf) -> str:
    if _is_array(leaf):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return "int32"
    raise TypeError(f"checkpoint leaves are tensors or ints, not "
                    f"{type(leaf).__name__}")


def _to_host(leaf) -> np.ndarray:
    """The array written for ``leaf``: bf16 as its uint16 bits."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    t = leaf.whole() if isinstance(leaf, ZeroShards) else leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The CPU tensor of a leaf read as ``arr`` under manifest ``dtype``."""
    if dtype == "bfloat16":
        # reinterpret the bits as int16 first: torch.from_numpy of a uint16
        # array is not supported by every torch release
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype)
    return torch.from_numpy(arr if arr.dtype == want else arr.view(want))


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes (the reference's ``tobytes()`` CRC,
    without the copy)."""
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B")) \
        & 0xFFFFFFFF


def _flatten(tree) -> dict:
    return {"/".join(map(str, path)): leaf for path, leaf in flatten(tree)}


def _pid_alive(pid: int) -> bool:
    """True when ``pid`` is a live process (signal-0 probe). A pid we lack
    permission to signal is someone else's live process, not an orphan."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _sweep_tmp(ckpt_dir: Path) -> None:
    """Remove the ``.tmp-*`` directories of writers that died. The name
    carries the writer's pid (``.tmp-{step}-{pid}-{uuid}``); a live
    writer's directory is left alone, and so is a name that does not
    parse."""
    for p in ckpt_dir.glob(".tmp-*"):
        if not p.is_dir():
            continue
        parts = p.name.split("-")
        try:
            pid = int(parts[2])
        except (IndexError, ValueError):
            continue
        if _pid_alive(pid):
            continue
        shutil.rmtree(p, ignore_errors=True)


def _add(timings: Optional[dict], key: str, value) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0) + value


def save(ckpt_dir: str | Path, step: int, tree, keep: int = 3,
         extra: Optional[dict] = None,
         timings: Optional[dict] = None) -> Path:
    """Write ``tree`` as step ``step``; returns the step's directory.
    ``timings``, when given, gains the seconds of the device synchronise
    (``sync_s``), the copies to the host (``d2h_s``), the checksums
    (``crc_s``) and the writes (``write_s``), and the ``bytes`` written."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    _sweep_tmp(ckpt_dir)
    flat = _flatten(tree)
    t0 = time.perf_counter()
    # every stage stream too: a leaf is read only after each kernel that
    # writes it has ended
    for dev in _cuda_indices(flat.values()):
        torch.cuda.synchronize(dev)
    _add(timings, "sync_s", time.perf_counter() - t0)
    # the uuid: a restart that reuses this pid never renames over (or
    # into) a half-written tree of its previous incarnation
    tmp = ckpt_dir / f".tmp-{step}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"format": 2, "step": step, "time": time.time(),
                "extra": extra or {}, "leaves": {}}
    for key, leaf in flat.items():
        t0 = time.perf_counter()
        bits = _to_host(leaf)              # one leaf on the host at a time
        t1 = time.perf_counter()
        crc = _crc(bits)
        t2 = time.perf_counter()
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, bits)
        _add(timings, "d2h_s", t1 - t0)
        _add(timings, "crc_s", t2 - t1)
        _add(timings, "write_s", time.perf_counter() - t2)
        _add(timings, "bytes", bits.nbytes)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(bits.shape),
            "dtype": _dtype_name(leaf), "crc32": crc}
        del bits
    t0 = time.perf_counter()
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = ckpt_dir / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(ckpt_dir, keep)
    _add(timings, "write_s", time.perf_counter() - t0)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def all_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    return sorted(int(p.name.split("_")[1])
                  for p in ckpt_dir.glob("step_*") if p.is_dir())


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read(d: Path, key: str, info: dict) -> np.ndarray:
    try:
        arr = np.load(d / info["file"])
    except (OSError, ValueError, EOFError) as e:
        raise CheckpointCorruptError(
            f"{d}: leaf {key} unreadable ({e!r})") from e
    if tuple(arr.shape) != tuple(info["shape"]):
        raise CheckpointCorruptError(
            f"{d}: leaf {key} shape {arr.shape} != manifest {info['shape']}")
    return arr


def load(ckpt_dir: str | Path, tree_like, step: Optional[int] = None,
         timings: Optional[dict] = None):
    """Restore step ``step`` (default: the newest) into ``tree_like`` in
    place: every tensor leaf receives its saved value by ``copy_`` and keeps
    its identity, an ``int`` leaf is replaced by the saved one. Returns
    ``(state, manifest)``, ``state`` a tree of ``tree_like``'s structure
    holding its tensors. ``timings``, when given, gains ``load_s`` and the
    ``bytes`` read.

    Raises :class:`CheckpointCorruptError` on a torn step (missing manifest
    or leaf file, a truncated ``.npy``, a checksum mismatch), ``KeyError``
    when the leaf sets differ and ``ValueError`` when a leaf's shape or
    dtype differs from its live tensor's. Every check runs before the
    first copy, so a step that fails leaves ``tree_like`` untouched.
    """
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    t_start = time.perf_counter()
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"{d}: manifest missing or unreadable ({e!r})") from e

    flat_like = _flatten(tree_like)
    # a checkpoint with extra or missing leaves is another model: refuse
    # it rather than load the intersection
    ck_keys, my_keys = set(manifest["leaves"]), set(flat_like)
    if ck_keys != my_keys:
        missing = sorted(my_keys - ck_keys)[:3]
        extra = sorted(ck_keys - my_keys)[:3]
        raise KeyError(
            f"{d}: leaf set mismatch (checkpoint has {len(ck_keys)} leaves, "
            f"model has {len(my_keys)}; missing={missing} extra={extra})")
    for key, leaf in flat_like.items():
        info = manifest["leaves"][key]
        shape = tuple(leaf.shape) if _is_array(leaf) else ()
        if (tuple(info["shape"]), info["dtype"]) != (shape, _dtype_name(leaf)):
            raise ValueError(
                f"{d}: leaf {key} is {info['dtype']}{info['shape']} in the "
                f"checkpoint, {_dtype_name(leaf)}{list(shape)} in the model")
    # every leaf's checksum before the first copy: a corrupt leaf found
    # after others were copied would leave the live state torn between
    # two steps (host memory still holds one leaf at a time)
    for key in flat_like:
        info = manifest["leaves"][key]
        if "crc32" in info and _crc(_read(d, key, info)) != info["crc32"]:
            raise CheckpointCorruptError(
                f"{d}: leaf {key} failed checksum (torn or corrupted write)")
    pairs, nbytes = [], 0
    with torch.no_grad():
        for path, leaf in flatten(tree_like):
            key = "/".join(map(str, path))
            info = manifest["leaves"][key]
            arr = _read(d, key, info)
            nbytes += arr.nbytes
            if _is_array(leaf):
                leaf.copy_(_from_host(arr, info["dtype"]))
                pairs.append((path, leaf))
            else:
                pairs.append((path, int(arr)))
            del arr
        for dev in _cuda_indices(x for _, x in pairs):
            torch.cuda.synchronize(dev)
    _add(timings, "load_s", time.perf_counter() - t_start)
    _add(timings, "bytes", nbytes)
    return unflatten(pairs), manifest


def load_latest_valid(ckpt_dir: str | Path, tree_like,
                      timings: Optional[dict] = None):
    """The newest restorable step, loaded into ``tree_like`` in place:
    steps are tried newest first, and one that is torn, corrupt or
    incompatible is skipped with a warning (and left ``tree_like``
    untouched). Returns ``(state, manifest)``; raises ``FileNotFoundError``
    when no step restores."""
    steps = all_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    last_err: Optional[Exception] = None
    for step in reversed(steps):
        try:
            return load(ckpt_dir, tree_like, step, timings=timings)
        except (CheckpointCorruptError, KeyError, ValueError, TypeError) as e:
            warnings.warn(f"checkpoint step {step} under {ckpt_dir} not "
                          f"restorable ({e!r}); trying previous", stacklevel=2)
            last_err = e
    raise FileNotFoundError(
        f"no restorable checkpoint under {ckpt_dir}: {last_err!r}")


def restore_or_init(ckpt_dir, init_fn, timings: Optional[dict] = None):
    """Restart helper: ``init_fn()`` builds the live state, into which the
    newest valid step is restored in place if one exists. Returns
    ``(state, start_step)``. A directory whose steps do not fit the model
    (another run's) leaves the fresh state, with a warning."""
    state = init_fn()
    if latest_step(ckpt_dir) is None:
        return state, 0
    try:
        restored, manifest = load_latest_valid(ckpt_dir, state, timings)
    except (FileNotFoundError, KeyError, ValueError, TypeError) as e:
        warnings.warn(f"no checkpoint under {ckpt_dir} is compatible with "
                      f"the current model ({e!r}); initializing fresh",
                      stacklevel=2)
        return state, 0
    return restored, int(manifest["step"])

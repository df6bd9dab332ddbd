"""Mesh construction, counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device. A mesh here is :class:`repro_torch.dist.sharding.Mesh`, axis names
over an array of ``torch.device``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, (16, 16) data x model or (2, 16,
    16) pod x data x model, as an abstract mesh: axis names and sizes, no
    devices. The spec functions and a dry run read only those."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, axis_sizes=shape)


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh_devices(n: int, devices: Optional[Sequence], what: str) -> list:
    """``devices`` (``n`` of them) or the first ``n`` CUDA devices; never
    a repeated device or the CPU unasked."""
    if devices is None:
        devs = _cuda_devices()
        if n > len(devs):
            raise ValueError(
                f"need {n} devices for {what}, have {len(devs)} CUDA devices "
                f"(pass devices=, e.g. ['cuda:0'] * {n} or ['cpu'] * {n})")
        return devs[:n]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {what}")
    return [torch.device(d) for d in devices]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` in row-major order, by default
    the first CUDA devices (raising when there are fewer). A caller that
    wants a device repeated names it: ``["cpu"] * 8`` (the tests' (2, 4)
    mesh in one CPU process) or ``["cuda:0"] * 4`` (a (2, 2) mesh on one
    card, each shard running its own program there)."""
    n = 1
    for s in shape:
        n *= int(s)
    arr = np.empty(n, dtype=object)
    arr[:] = _mesh_devices(n, devices, f"a {tuple(shape)} mesh")
    return Mesh(arr.reshape(shape), axes)


def make_stage_mesh(n_stages: int, *, axis: str = "stage",
                    devices: Optional[Sequence] = None) -> Mesh:
    """1-D pipeline-stage mesh: stage ``s`` on ``devices[s]``.

    By default the first ``n_stages`` CUDA devices; with fewer this raises,
    as the reference does, and never repeats a device or takes the CPU
    unasked. A caller that wants otherwise names the devices:
    ``["cpu"] * 4`` (four stages in one CPU process, the tests' mesh) or
    ``["cuda:0"] * 4`` (a 4-stage ring on one card). The axis name must be
    one of ``repro_torch.dist.sharding._STAGE_AXES`` for the ZeRO-1
    ``"zero"`` dim to resolve onto it."""
    devices = _mesh_devices(n_stages, devices,
                            f"{n_stages} pipeline stages")
    return Mesh(devices, (axis,))


def make_host_mesh(data: int = 1, model: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """Small data x model mesh, as the reference's over its host devices
    (tests and examples). Over ``devices`` when given (``data * model`` of
    them); otherwise over however many CUDA devices exist, the sizes cut
    to fit them."""
    if devices is None:
        n = max(1, len(_cuda_devices()))
        data = min(data, n)
        model = min(model, max(1, n // data))
    return make_mesh((data, model), ("data", "model"), devices=devices)


def meta_mesh(mesh: Mesh) -> Mesh:
    """``mesh``'s axes over ``meta`` devices: a shard group on it runs
    every rank's program by shape alone (a dry run)."""
    n = 1
    for s in mesh.shape.values():
        n *= s
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device("meta")] * n
    return Mesh(arr.reshape(tuple(mesh.shape.values())), mesh.axis_names)

"""Logical-axis sharding: the contract between models and the mesh.

Counterpart of ``repro.dist.sharding``. Model code never names mesh axes.
It annotates tensors with *logical* dims: ``"dp"`` (batch, data
parallel), ``"tp"`` (tensor, model parallel), ``"sp"`` (sequence
parallel), ``"ep"`` (expert parallel), ``"zero"`` (optimizer-state
partitioning) or ``None`` (replicated). This module resolves them against
a :class:`Mesh`, the one passed or the ambient one of :func:`set_mesh`:

======== ============================================ =====================
logical  resolves to mesh axes                        typical tensor dim
======== ============================================ =====================
``dp``   every batch-like axis (``pod``, ``data``)    batch
``tp``   the ``model`` axis                           heads / d_ff / vocab
``sp``   the ``model`` axis (same hardware, seq dim)  sequence
``ep``   the ``model`` axis                           experts
``zero`` batch-like + pipeline-stage axes (ZeRO-1)    largest divisible dim
======== ============================================ =====================

The resolution rules are the reference's: no mesh, no constraint
(``spec_for`` gives ``P()``); a mesh axis goes only to a dim whose size it
divides; a mesh axis is used at most once per spec, the first dim that
passes taking it; trailing ``None`` entries are dropped. :func:`pure_dp`
remaps every model-parallel name to nothing and ``dp`` to all axes.
:func:`zero1_logical` marks the largest dim the ``zero`` axes divide, and
:func:`spec_for_zero` resolves the result.

What differs from the reference is what a mesh is. The port's
:class:`Mesh` is its own small type: axis names, sizes, and an object
array of ``torch.device`` (``None`` for an abstract mesh, which the spec
functions and a dry run need and which holds no device). The stage mesh
of the mesh backend (``repro_torch.dist.backend.MeshBackend``) is one
process driving a list of devices, which may repeat one card. Sharding a
tensor *inside* a stage (the ``data`` and ``model`` axes through GSPMD in
the reference) runs in a shard group (``repro_torch.dist.spmd``): there a
value is a ``spmd.Sharded`` and :func:`shard` is the layout change its
spec names (gathers, reduce-scatters, slices). Outside a running group
:func:`shard` returns its input wherever the resolved spec is empty, and
raises ``NotImplementedError`` (:data:`IN_STAGE_SHARDING`) where it is
not: the reference's GSPMD splits a bare tensor under such a mesh, while
the port splits only the ``Sharded`` values of a group, which
``models/model.py``'s entry points open whenever the ambient mesh shards
inside the stage.

:class:`ZeroShards` is one optimizer-state leaf placed by ZeRO-1: its
chunks along one dim, chunk ``s`` on stage ``s``'s device (the first of
its row where the stage mesh has further axes).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

LogicalDim = Union[str, None, tuple]

# mesh-axis name classes; launch/mesh.py uses ("pod", "data", "model") and
# make_stage_mesh uses ("stage",) for the pipeline axis
_BATCH_AXES = ("pod", "data", "dp", "batch", "replica")
_MODEL_AXES = ("model", "tp", "mdl", "tensor")
_STAGE_AXES = ("stage", "pipe", "stages")

IN_STAGE_SHARDING = ("sharding inside a pipeline stage (the data/model "
                     "axes: dp, tp, sp, ep) runs only in a shard group "
                     "(repro_torch.dist.spmd), which the model's entry "
                     "points open; a tensor outside one is not split")

_tls = threading.local()


class PartitionSpec(tuple):
    """A resolved layout: one entry per tensor dim, a mesh axis name, a
    tuple of names, or ``None``. Compares as the tuple of its entries, as
    JAX's does."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named mesh axes over an array of ``torch.device``.

    ``Mesh(devices, axis_names)``: ``devices`` an array-like of devices (or
    device strings) of one dim per axis; a device may appear more than
    once. ``Mesh(None, axis_names, axis_sizes=...)`` is abstract: sizes
    only, no device. ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 axis_sizes: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        if devices is None:
            if axis_sizes is None:
                raise ValueError("an abstract mesh needs axis_sizes")
            sizes = tuple(int(s) for s in axis_sizes)
            self.devices = None
        else:
            arr = np.asarray(devices, dtype=object)
            flat = [torch.device(d) for d in arr.flat]
            self.devices = np.empty(arr.shape, dtype=object)
            for i, d in enumerate(flat):
                self.devices.flat[i] = d
            sizes = tuple(self.devices.shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{len(sizes)} mesh dims for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, sizes))

    def __repr__(self) -> str:
        where = ("abstract" if self.devices is None
                 else [str(d) for d in self.devices.flat])
        return f"Mesh({self.shape}, {where})"


# ----------------------------------------------------------------------
# ambient mesh + pure-DP mode
# ----------------------------------------------------------------------
@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the ambient mesh of this thread while the context is
    open (the port's ``jax.set_mesh``)."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`set_mesh` block, or None."""
    return getattr(_tls, "mesh", None)


def is_pure_dp() -> bool:
    return bool(getattr(_tls, "pure_dp", False))


@contextlib.contextmanager
def pure_dp(enabled: bool = True):
    """Treat every mesh axis as data parallelism while the context is open:
    ``tp``/``sp``/``ep`` resolve to no axes and ``dp`` to the whole mesh.
    ``with pure_dp(False)`` is a no-op."""
    prev = getattr(_tls, "pure_dp", False)
    _tls.pure_dp = bool(enabled)
    try:
        yield
    finally:
        _tls.pure_dp = prev


# ----------------------------------------------------------------------
# logical-name -> mesh-axes resolution
# ----------------------------------------------------------------------
def axis_map(mesh: Optional[Mesh] = None) -> dict:
    """Map each logical name to the tuple of mesh axis names it may use."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return {}
    names = tuple(mesh.axis_names)
    if is_pure_dp():
        return {"dp": names, "tp": (), "sp": (), "ep": (), "zero": names}
    batch = tuple(a for a in names if a in _BATCH_AXES)
    model = tuple(a for a in names if a in _MODEL_AXES)
    stage = tuple(a for a in names if a in _STAGE_AXES)
    # ZeRO shards optimizer state over DP replicas and the pipeline-stage
    # axis; dp itself never resolves to the stage axis (stages hold
    # different micro-batches, not replicas of the batch)
    return {"dp": batch, "tp": model, "sp": model, "ep": model,
            "zero": batch + stage}


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    """Product of the mesh-axis sizes a logical name resolves to (1 with no
    mesh)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return 1
    size = 1
    for a in axis_map(mesh).get(name, ()):
        size *= mesh.shape[a]
    return size


def _resolve_dim(names, dim_size: int, amap: dict, mesh: Mesh,
                 used: set) -> list:
    """Mesh axes for one tensor dim, honoring divisibility and
    first-dim-wins."""
    axes: list = []
    prod = 1
    for nm in names:
        for a in amap.get(nm, ()):
            if a in used or a in axes:
                continue
            sz = mesh.shape[a]
            if sz <= 1 or dim_size % (prod * sz):
                continue
            axes.append(a)
            prod *= sz
    return axes


def spec_for(shape: Sequence[int], logical: Sequence[LogicalDim],
             mesh: Optional[Mesh] = None) -> PartitionSpec:
    """Resolve a logical tuple against the mesh into a ``PartitionSpec``.
    An entry may be a name, ``None``, or a tuple of names (as
    :func:`zero1_logical` emits). With no mesh: ``P()``."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return P()
    amap = axis_map(mesh)
    used: set = set()
    entries: list = []
    for dim_size, lg in zip(shape, logical):
        if lg is None:
            entries.append(None)
            continue
        names = tuple(lg) if isinstance(lg, (tuple, list)) else (lg,)
        axes = _resolve_dim(names, int(dim_size), amap, mesh, used)
        used.update(axes)
        if not axes:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(tuple(axes))
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def shard(x, *logical: LogicalDim, mesh: Optional[Mesh] = None):
    """Annotate an activation with its logical placement. A
    ``spmd.Sharded`` value (inside a shard group) comes back in the layout
    the spec names. For a tensor: without a mesh, or where the mesh gives
    it no axis (a stage-only mesh, dims that fail divisibility), the
    identity; a placement that would split it raises
    (:data:`IN_STAGE_SHARDING`: only a shard group splits)."""
    from repro_torch.dist import spmd
    if isinstance(x, spmd.Sharded):
        mesh = mesh if mesh is not None else x.group.mesh
        return spmd.redistribute(x, spec_for(x.shape, logical, mesh))
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return x
    spec = spec_for(x.shape, logical, mesh)
    if not len(spec):
        return x
    raise NotImplementedError(f"{IN_STAGE_SHARDING}: {tuple(x.shape)} -> "
                              f"{spec} on {mesh} outside a shard group")


def is_logical(x) -> bool:
    """A logical tuple: names and ``None``s (a leaf of a logical tree)."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_logical(fn, logical, *rest):
    """``fn(lg, *nodes)`` over each logical tuple of the tree ``logical``
    (dicts, tuples and lists of logical tuples) and the nodes at the same
    place in the trees ``rest``; returns a tree of ``logical``'s
    structure."""
    if is_logical(logical):
        return fn(logical, *rest)
    if isinstance(logical, dict):
        return {k: map_logical(fn, v, *(r[k] for r in rest))
                for k, v in logical.items()}
    return type(logical)(map_logical(fn, v, *(r[i] for r in rest))
                         for i, v in enumerate(logical))


# ----------------------------------------------------------------------
# ZeRO partitioning
# ----------------------------------------------------------------------
def zero1_logical(logical: Sequence[LogicalDim], shape: Sequence[int],
                  mesh: Optional[Mesh] = None) -> tuple:
    """Upgrade a parameter's logical tuple for ZeRO partitioning: the
    largest unsharded dim the ``zero`` axes divide becomes ``"zero"``;
    failing that, a ``tp`` dim they co-divide becomes ``(name, "zero")``;
    failing that (or with no mesh) the tuple comes back unchanged."""
    logical = tuple(logical)
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return logical
    z = axis_size("zero", mesh)
    if z <= 1:
        return logical
    best = -1
    for i, (d, lg) in enumerate(zip(shape, logical)):
        if lg is None and d % z == 0 and (best < 0 or d > shape[best]):
            best = i
    if best >= 0:
        out = list(logical)
        out[best] = "zero"
        return tuple(out)
    for i, (d, lg) in enumerate(zip(shape, logical)):
        if isinstance(lg, str):
            t = axis_size(lg, mesh)
            if t > 0 and d % (t * z) == 0:
                out = list(logical)
                out[i] = (lg, "zero")
                return tuple(out)
    return logical


def spec_for_zero(shape: Sequence[int], zlogical: Sequence[LogicalDim],
                  mesh: Optional[Mesh] = None) -> PartitionSpec:
    """Resolve a :func:`zero1_logical` tuple: the rules of
    :func:`spec_for`, a separate entry point as in the reference."""
    return spec_for(shape, zlogical, mesh)


class ZeroShards:
    """One optimizer-state leaf split by ZeRO-1 along ``dim``: ``chunks[s]``
    is the ``s``-th equal part, on stage ``s``'s device. ``shape`` and
    ``dtype`` are the whole leaf's; :meth:`whole` gathers it and
    :meth:`copy_` scatters a whole value into the chunks (a checkpoint
    writes and restores the leaf whole)."""

    __slots__ = ("chunks", "dim")

    def __init__(self, chunks: list, dim: int):
        self.chunks, self.dim = list(chunks), int(dim)

    @property
    def shape(self) -> torch.Size:
        s = list(self.chunks[0].shape)
        s[self.dim] *= len(self.chunks)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.chunks[0].dtype

    @property
    def devices(self) -> list:
        return [c.device for c in self.chunks]

    def bounds(self, s: int) -> tuple[int, int, int]:
        """``(dim, start, length)`` of chunk ``s`` in the whole leaf, the
        arguments of ``Tensor.narrow``."""
        n = self.chunks[s].shape[self.dim]
        return self.dim, s * n, n

    def whole(self, device="cpu") -> torch.Tensor:
        return torch.cat([c.to(device) for c in self.chunks], self.dim)

    def copy_(self, src: torch.Tensor) -> "ZeroShards":
        for s, c in enumerate(self.chunks):
            c.copy_(src.narrow(*self.bounds(s)))
        return self

    def __repr__(self) -> str:
        return (f"ZeroShards({list(self.shape)}, {self.dtype}, dim "
                f"{self.dim}, on {[str(d) for d in self.devices]})")

"""The shard group: sharding inside a stage, one controller in lockstep.

Counterpart of what GSPMD does for the reference under a (data, model)
mesh (``repro.dist.sharding.shard`` as ``with_sharding_constraint``, and
``jax.shard_map`` for the MoE layer). One process drives every device of
a :class:`~repro_torch.dist.sharding.Mesh` that has devices; the list may
repeat one card (``["cuda:0"] * 4``) or the CPU (``["cpu"] * 8``, the
tests' mesh). Each shard's program is its own: its slices of the weights
and activations, its own products and kernel launches at its own shapes.

A distributed value is a :class:`Sharded`: one local tensor per rank (flat
rank, row-major over the mesh's axes), its layout as a ``PartitionSpec``
(a tuple of mesh axes per dim) and the mesh axes over which its locals
are still addends of one sum (``partial``, the row-parallel products'
outputs). :meth:`ShardGroup.map` runs a local function on every rank in
ascending order; the collectives combine the locals:

- :func:`all_reduce` over the mesh axes named, each group summed in
  ascending rank (in fp32 for floating dtypes, then cast back), every
  member given its copy;
- :func:`all_gather` along a dim, the chunks in the order of their index;
- :func:`reduce_scatter` along a dim, summed in ascending rank, chunk
  ``i`` to the member whose chunk index is ``i``;
- :func:`merge_attention`, the attention partials of each member's slice
  of the keys, ``(o_r, lse_r)``, merged into the attention over all of
  them (:func:`merge_partials`, in ascending rank, in fp32): the decode
  step's combine over a KV cache split along its sequence. It takes no
  gradient (serving only).

Each is an autograd function whose backward is its transpose (all-reduce,
reduce-scatter, all-gather), so one graph holds every shard's program and
``torch.autograd.grad`` walks it once, in reverse, on one thread: no
shard waits on another, and a collective's backward sums in the same
fixed order as its forward, so a step repeats bit for bit. A period's
recompute is the stack's own checkpoint, which runs the collectives again.
Every collective adds one to :func:`collective_counts` and charges its
link bytes by formula to the open ``launch.op_cost`` counters.

:func:`redistribute` is the layout change that ``shard(x, *logical)``
names inside a running group (:func:`running`): partial sums reduced (by
a reduce-scatter where the target splits a dim over the same axes),
split dims gathered, then dims split by slicing the local copy.
:func:`value_and_grad` takes the gradient of a function of a tree of
:class:`Sharded` parameters and sums each leaf's gradient over the mesh
axes that hold copies of its slice, in ascending rank.

A mesh of ``["meta"] * n`` runs the group's programs on ``meta`` (a dry
run): every op by shape, and each collective's outputs made by shape
alone and charged by formula. Each rank's code runs inside
``op_cost.rank_scope`` so that ``OpCounter(rank=r)`` counts one device's
share. A group made with ``representative=True`` (on ``meta`` only, where
every rank's inputs have rank 0's shapes) traces rank 0 alone: its locals
stand in for every other rank's (:meth:`ShardGroup.per_rank`), and a
collective makes rank 0's output only. ``tests/test_torch_dryrun.py``
holds such a trace equal to one of every rank.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.dist.sharding import (Mesh, P, ambient_mesh, axis_map,
                                       is_pure_dp, pure_dp, set_mesh)
from repro_torch.launch import op_cost
from repro_torch.launch.op_cost import rank_scope

_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "attention_merge")
_COUNTS = dict.fromkeys(_KINDS, 0)
_LINK_BYTES = dict.fromkeys(_KINDS, 0.0)
_lock = threading.Lock()
_tls = threading.local()


def collective_counts() -> dict[str, int]:
    """Collectives run since the last reset, by kind (forward and backward,
    a recompute included)."""
    with _lock:
        return dict(_COUNTS)


def collective_link_bytes() -> dict[str, float]:
    """Per-device link bytes of those collectives by the ring formulas of
    ``launch.op_cost.link_bytes``."""
    with _lock:
        return dict(_LINK_BYTES)


def reset_collective_counts() -> None:
    with _lock:
        for k in _COUNTS:
            _COUNTS[k] = 0
            _LINK_BYTES[k] = 0.0


def _count(kind: str, out_bytes: int, g: int) -> None:
    link = op_cost.link_bytes(kind.replace("_", "-"), out_bytes, g)
    with _lock:
        _COUNTS[kind] += 1
        _LINK_BYTES[kind] += link
    op_cost.charge_collective(kind.replace("_", "-"), out_bytes, g)


# ----------------------------------------------------------------------
# the group
# ----------------------------------------------------------------------
def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def norm_spec(spec, ndim: int) -> tuple:
    """A spec as one tuple of mesh axes per dim, ``ndim`` long."""
    entries = [_axes(e) for e in tuple(spec)]
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} for a {ndim}-dim tensor")
    return tuple(entries) + ((),) * (ndim - len(entries))


def to_pspec(spec: tuple) -> P:
    entries = [None if not a else (a[0] if len(a) == 1 else a) for a in spec]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


class ShardGroup:
    """The ranks of a mesh with devices: rank ``r`` is the ``r``-th device
    of ``mesh.devices`` in row-major order. ``representative``: trace rank
    0 alone, its values standing in for the rest (``meta`` meshes only)."""

    def __init__(self, mesh: Mesh, *, representative: bool = False):
        if mesh.devices is None:
            raise ValueError(f"{mesh} is abstract: a shard group needs "
                             "devices")
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.sizes = tuple(mesh.devices.shape)
        self.devices = list(mesh.devices.flat)
        self.n = len(self.devices)
        self.meta = all(d.type == "meta" for d in self.devices)
        if representative and not self.meta:
            raise ValueError("a representative rank is traced on meta only")
        self.traced = [0] if representative else list(range(self.n))
        self._coords = [dict(zip(self.axis_names,
                                 np.unravel_index(r, self.sizes)))
                        for r in range(self.n)]

    def __repr__(self) -> str:
        rep = ", rank 0 for all" if len(self.traced) < self.n else ""
        return f"ShardGroup({self.mesh}{rep})"

    def fill(self, got: dict) -> list:
        """The list of every rank's value from ``{rank: value}`` of the
        traced ranks, rank 0's standing in for the rest."""
        return [got[r] if r in got else got[0] for r in range(self.n)]

    def per_rank(self, fn: Callable) -> list:
        """``[fn(r) for each rank]``, each call inside its rank's
        ``op_cost.rank_scope``; only the traced ranks are called."""
        got = {}
        for r in self.traced:
            with rank_scope(r):
                got[r] = fn(r)
        return self.fill(got)

    def coord(self, r: int, axis: str) -> int:
        return int(self._coords[r][axis])

    def chunk(self, r: int, axes: tuple) -> tuple[int, int]:
        """``(index, count)`` of rank ``r``'s chunk of a dim split over
        ``axes``, the first axis major."""
        i, n = 0, 1
        for a in axes:
            s = self.mesh.shape[a]
            i, n = i * s + self.coord(r, a), n * s
        return i, n

    def groups(self, axes: tuple) -> list[list[int]]:
        """The ranks that differ only along ``axes``, each group in
        ascending rank."""
        others = [a for a in self.axis_names if a not in axes]
        out: dict = {}
        for r in range(self.n):
            out.setdefault(tuple(self.coord(r, a) for a in others),
                           []).append(r)
        return list(out.values())

    def map(self, fn: Callable, *args, **kwargs) -> list:
        """``fn`` on every traced rank in ascending order, each :class:`Sharded`
        in ``args``/``kwargs`` (nested in dicts, lists and tuples too)
        replaced by its local tensor: the list of results."""
        return self.per_rank(lambda r: fn(*local(args, r),
                                          **local(kwargs, r)))


@contextlib.contextmanager
def running(group: ShardGroup):
    """Make ``group`` the running shard group of this thread."""
    prev = getattr(_tls, "group", None)
    _tls.group = group
    try:
        yield group
    finally:
        _tls.group = prev


def whole_recompute(x):
    """Around a checkpoint of a value ``x``: where ``x`` is a
    :class:`Sharded`, its recompute runs every op of the function, not
    stopping early once the saved tensors are rebuilt. Where an early stop
    falls depends on which ranks run (a representative rank's recompute
    would stop before the whole group's), so without this a dry run could
    not let one rank stand for all. Elsewhere nothing changes."""
    if isinstance(x, Sharded):
        return set_checkpoint_early_stop(False)
    return contextlib.nullcontext()


def group_checkpoint(x, kwargs: dict) -> dict:
    """``torch.utils.checkpoint`` keyword arguments for a function of a
    value ``x``: where ``x`` is a :class:`Sharded`, the recompute re-enters
    this thread's ambient mesh, ``pure_dp`` flag and running group, which
    live in thread-local state and which the thread autograd runs a CUDA
    backward in does not have (``kwargs``' own ``context_fn`` kept inside).
    Elsewhere ``kwargs`` as they are."""
    if not isinstance(x, Sharded):
        return kwargs
    mesh, flag, group = ambient_mesh(), is_pure_dp(), current_group()
    inner = kwargs.get("context_fn")

    @contextlib.contextmanager
    def restored(ctx):
        with set_mesh(mesh), pure_dp(flag), running(group), ctx:
            yield

    def context_fn():
        fwd, rec = (inner() if inner is not None
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, restored(rec)
    return {**kwargs, "context_fn": context_fn}


def current_group() -> Optional[ShardGroup]:
    return getattr(_tls, "group", None)


def in_stage_mesh(mesh: Optional[Mesh] = None) -> bool:
    """Whether ``mesh`` (else the ambient one) shards inside a stage: it
    has devices and a data or model axis (size 1 included, as the
    reference's MoE takes its shard_map on a (1, 1) mesh)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None or mesh.devices is None:
        return False
    amap = axis_map(mesh)
    return bool(amap.get("dp") or amap.get("tp"))


# ----------------------------------------------------------------------
# distributed values
# ----------------------------------------------------------------------
class Sharded:
    """A tensor over a shard group: ``locals[r]`` on rank ``r``'s device,
    ``spec`` one tuple of mesh axes per dim, ``partial`` the mesh axes
    whose members hold addends of the value."""

    __slots__ = ("group", "locals", "spec", "partial")

    def __init__(self, group: ShardGroup, locals_: Sequence[torch.Tensor],
                 spec=(), partial: tuple = ()):
        if len(locals_) != group.n:
            raise ValueError(f"{len(locals_)} locals for {group.n} ranks")
        self.group = group
        self.locals = list(locals_)
        self.spec = norm_spec(spec, self.locals[0].dim())
        self.partial = tuple(partial)

    @property
    def shape(self) -> torch.Size:
        """The whole tensor's shape."""
        s = list(self.locals[0].shape)
        for d, axes in enumerate(self.spec):
            for a in axes:
                s[d] *= self.group.mesh.shape[a]
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.locals[0].dtype

    @property
    def pspec(self) -> P:
        return to_pspec(self.spec)

    def dim(self) -> int:
        return self.locals[0].dim()

    def with_locals(self, locals_, spec=None, partial=None) -> "Sharded":
        return Sharded(self.group, locals_,
                       self.spec if spec is None else spec,
                       self.partial if partial is None else partial)

    def map(self, fn, *others) -> "Sharded":
        """``fn`` elementwise over the locals of ``self`` and ``others``
        (same layout), keeping the layout."""
        return self.with_locals(self.group.map(fn, self, *others))

    def __repr__(self) -> str:
        return (f"Sharded({list(self.shape)}, {self.dtype}, {self.pspec}"
                f"{', partial ' + str(self.partial) if self.partial else ''}"
                f", {self.group.n} ranks)")


def local(tree, r: int):
    """``tree`` with each :class:`Sharded` replaced by its rank-``r``
    local."""
    if isinstance(tree, Sharded):
        return tree.locals[r]
    if isinstance(tree, dict):
        return {k: local(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local(v, r) for v in tree)
    return tree


def _chunk_slices(group: ShardGroup, r: int, spec: tuple, shape) -> list:
    out = []
    for d, axes in enumerate(spec):
        i, n = group.chunk(r, axes)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes}")
        size = shape[d] // n
        out.append((d, i * size, size))
    return out


def split(x: torch.Tensor, spec, group: ShardGroup) -> Sharded:
    """``x`` split by ``spec``: each rank a copy of its chunk on its
    device. Differentiable."""
    spec = norm_spec(spec, x.dim())

    def part(r):
        y = x
        for d, start, size in _chunk_slices(group, r, spec, x.shape):
            if size != x.shape[d]:
                y = y.narrow(d, start, size)
        return y.to(group.devices[r], copy=True).contiguous()
    return Sharded(group, group.per_rank(part), spec)


def zeros(shape, spec, dtype, group: ShardGroup) -> Sharded:
    """A zero tensor of ``shape`` laid out by ``spec``: each rank its
    chunk, made on its device (on ``meta``, by shape only)."""
    spec = norm_spec(spec, len(shape))

    def part(r):
        loc = [n for _, _, n in _chunk_slices(group, r, spec, shape)]
        return torch.zeros(loc, dtype=dtype, device=group.devices[r])
    return Sharded(group, group.per_rank(part), spec)


def own_chunk(s: Sharded, r: int, x: torch.Tensor) -> torch.Tensor:
    """Rank ``r``'s chunk, by ``s``'s layout, of ``x``: a view of ``x``
    narrowed along each dim that ``s`` splits and ``x`` holds whole (a
    dim already at the local size, such as the rows, is kept)."""
    for d, axes in enumerate(s.spec):
        if not axes or x.shape[d] == s.locals[r].shape[d]:
            continue
        i, n = s.group.chunk(r, axes)
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x


def join(s: Sharded, device=None) -> torch.Tensor:
    """The whole tensor of ``s`` on ``device`` (rank 0's by default):
    partial sums reduced, chunks put in place."""
    if s.partial:
        s = s.with_locals(all_reduce(s.locals, s.group, s.partial),
                          partial=())
    device = s.group.devices[0] if device is None else torch.device(device)
    shape = s.shape
    out = torch.empty(shape, dtype=s.dtype, device=device)
    seen = set()
    for r in range(s.group.n):
        sl = _chunk_slices(s.group, r, s.spec, shape)
        key = tuple(start for _, start, _ in sl)
        if key in seen:
            continue
        seen.add(key)
        idx = tuple(slice(start, start + size) for _, start, size in sl)
        out[idx] = s.locals[r].to(device)
    return out


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


def _sum(xs: list, dev) -> torch.Tensor:
    """``xs`` summed in list order on ``dev``, in fp32 for floats."""
    dt = _acc_dtype(xs[0].dtype)
    acc = xs[0].to(dev, dt, copy=True)
    for x in xs[1:]:
        acc.add_(x.to(dev, dt))
    return acc


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _size(group: ShardGroup, axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= group.mesh.shape[a]
    return n


def _by_shape(xs, group: ShardGroup, members: list, shape_of) -> dict:
    """On ``meta``: each traced member's output made by shape alone, in
    its rank's scope."""
    out = {}
    for m in members:
        with rank_scope(m):
            out[m] = torch.empty(shape_of(xs[m]), dtype=xs[m].dtype,
                                 device=group.devices[m])
    return out


def _collective(kind, xs, group: ShardGroup, axes: tuple, combine,
                shape_of) -> list:
    """One collective over each group of ranks along ``axes``:
    ``combine(members, traced)`` gives the traced members' outputs from
    every member's input (on ``meta``, ``shape_of`` gives their shapes);
    counted once."""
    out = {}
    traced = set(group.traced)
    for members in group.groups(axes):
        want = [m for m in members if m in traced]
        if not want:
            continue
        if group.meta:
            out.update(_by_shape(xs, group, want, shape_of))
        else:
            out.update(combine(members, want))
    full = group.fill(out)
    r0 = group.traced[0]
    _count(kind, _nbytes(full[r0]), _size(group, axes))
    return full


def _all_reduce_raw(xs, group: ShardGroup, axes: tuple) -> list:
    def combine(members, want):
        dt = xs[members[0]].dtype
        acc = _sum([xs[m] for m in members], group.devices[members[0]])
        return {m: acc.to(group.devices[m], dt, copy=True) for m in want}
    return _collective("all_reduce", xs, group, axes, combine,
                       lambda x: x.shape)


def _ordered(group: ShardGroup, members: list, axes: tuple) -> list:
    return sorted(members, key=lambda m: group.chunk(m, axes)[0])


def _all_gather_raw(xs, group: ShardGroup, axes: tuple, dim: int) -> list:
    n = _size(group, axes)

    def combine(members, want):
        dev = group.devices[members[0]]
        whole = torch.cat([xs[m].to(dev) for m in
                           _ordered(group, members, axes)], dim)
        return {m: whole.to(group.devices[m], copy=True) for m in want}

    def shape_of(x):
        s = list(x.shape)
        s[dim] *= n
        return s
    return _collective("all_gather", xs, group, axes, combine, shape_of)


def _reduce_scatter_raw(xs, group: ShardGroup, axes: tuple, dim: int) -> list:
    n = _size(group, axes)

    def combine(members, want):
        dt = xs[members[0]].dtype
        acc = _sum([xs[m] for m in members], group.devices[members[0]])
        parts = acc.chunk(len(members), dim)
        return {m: parts[group.chunk(m, axes)[0]].to(
            group.devices[m], dt, copy=True).contiguous() for m in want}

    def shape_of(x):
        s = list(x.shape)
        s[dim] //= n
        return s
    return _collective("reduce_scatter", xs, group, axes, combine, shape_of)


def _zeros_like_out(ctx, r):
    """The gradient of rank ``r``'s output that no op used: zeros, or on
    ``meta`` its shape alone."""
    group = ctx.meta[0]
    shape, dtype = ctx.like
    with rank_scope(r):
        if group.meta:
            return torch.empty(shape, dtype=dtype, device="meta")
        return torch.zeros(shape, dtype=dtype, device=group.devices[r])


class _Collective(torch.autograd.Function):
    """A collective whose backward is its transpose. It takes and gives
    the traced ranks' locals only (a representative group passes rank 0's
    alone)."""

    @staticmethod
    def forward(ctx, fwd, bwd, group, args, *xs):
        ctx.meta = (group, bwd, args)
        ctx.set_materialize_grads(False)
        full = fwd(group.fill(dict(zip(group.traced, xs))), group, *args)
        ctx.like = (full[group.traced[0]].shape, full[group.traced[0]].dtype)
        return tuple(full[r] for r in group.traced)

    @staticmethod
    def backward(ctx, *gs):
        group, bwd, args = ctx.meta
        full = [g if g is not None else _zeros_like_out(ctx, r)
                for r, g in zip(group.traced, gs)]
        out = bwd(group.fill(dict(zip(group.traced, full))), group, *args)
        return (None, None, None, None, *(out[r] for r in group.traced))


def _apply(fwd, bwd, xs, group: ShardGroup, *args) -> list:
    outs = _Collective.apply(fwd, bwd, group, args,
                             *(xs[r] for r in group.traced))
    return group.fill(dict(zip(group.traced, outs)))


def _trivial(group: ShardGroup, axes: tuple) -> bool:
    return all(group.mesh.shape[a] == 1 for a in axes)


def all_reduce(xs: list, group: ShardGroup, axes: tuple) -> list:
    """Sum over each group of ranks that differ along ``axes``."""
    if _trivial(group, axes):
        return list(xs)
    return _apply(_all_reduce_raw, _all_reduce_raw, xs, group, tuple(axes))


def all_gather(xs: list, group: ShardGroup, axes: tuple, dim: int) -> list:
    """Concatenate along ``dim`` the chunks of each group over ``axes``."""
    if _trivial(group, axes):
        return list(xs)
    return _apply(_all_gather_raw, _reduce_scatter_raw, xs, group,
                  tuple(axes), dim)


def reduce_scatter(xs: list, group: ShardGroup, axes: tuple,
                   dim: int) -> list:
    """Sum over each group along ``axes``, each member keeping its chunk
    of ``dim``."""
    if _trivial(group, axes):
        return list(xs)
    return _apply(_reduce_scatter_raw, _all_gather_raw, xs, group,
                  tuple(axes), dim)


def merge_partials(os: list, lses: list) -> tuple:
    """``(o, lse)`` of the attention over every part's keys from the
    parts' partials in list order: ``lse = log Σ_r exp(lse_r)`` and ``o =
    Σ_r exp(lse_r - lse) o_r``, in fp32; o (B, T, H, D), lse (B, H, T).
    A part with no visible key (o_r zero, lse_r the -1e30 sentinel) adds
    nothing, and where no part sees a key o is zero and lse stays near
    -1e30, with no NaN: every exponent is of a difference to the largest
    lse_r."""
    ls = [x.float() for x in lses]
    m = ls[0]
    for x in ls[1:]:
        m = torch.maximum(m, x)
    s = torch.zeros_like(m)
    for x in ls:
        s = s + torch.exp(x - m)
    lse = m + torch.log(s)
    o = None
    for x, l in zip(os, ls):
        w = torch.exp(l - lse).permute(0, 2, 1)[..., None]   # (B, T, H, 1)
        o = x.float() * w if o is None else o + x.float() * w
    return o, lse


def merge_attention(os: list, lses: list, group: ShardGroup,
                    axes: tuple, dtype=None) -> tuple[list, list]:
    """Each group of ranks along ``axes`` merges its members' attention
    partials (each over its slice of the keys) with
    :func:`merge_partials`, in ascending rank, and every member gets the
    merged ``(o, lse)``, o rounded once to ``dtype`` (default the
    partials'). Counted and charged as one collective,
    ``attention_merge``, whose link bytes are an all-reduce's of the
    partials o and lse (a ring with the merge as its sum); on ``meta`` the
    outputs are made by shape alone."""
    dtype = dtype or os[group.traced[0]].dtype
    if _trivial(group, axes):
        return [x.to(dtype) for x in os], list(lses)
    out_o, out_l = {}, {}
    traced = set(group.traced)
    for members in group.groups(axes):
        want = [m for m in members if m in traced]
        if not want:
            continue
        for m in want if group.meta else ():
            with rank_scope(m):
                out_o[m] = torch.empty_like(os[m], dtype=dtype)
                out_l[m] = torch.empty_like(lses[m])
        if group.meta:
            continue
        dev = group.devices[members[0]]
        order = _ordered(group, members, axes)
        o, lse = merge_partials([os[m].to(dev) for m in order],
                                [lses[m].to(dev) for m in order])
        for m in want:
            out_o[m] = o.to(group.devices[m], dtype, copy=True)
            out_l[m] = lse.to(group.devices[m], copy=True)
    full_o, full_l = group.fill(out_o), group.fill(out_l)
    r0 = group.traced[0]
    _count("attention_merge", _nbytes(os[r0]) + _nbytes(lses[r0]),
           _size(group, axes))
    return full_o, full_l


# ----------------------------------------------------------------------
# layout changes
# ----------------------------------------------------------------------
def redistribute(s: Sharded, spec) -> Sharded:
    """``s`` in the layout ``spec``: its partial sums reduced (a
    reduce-scatter onto the one dim that ``spec`` splits over exactly
    those axes and ``s`` does not, else an all-reduce), then each dim
    whose axes change gathered whole and split again by slicing."""
    g = s.group
    target = norm_spec(spec, s.dim())
    locals_, cur = s.locals, list(s.spec)
    if s.partial:
        dims = [d for d, axes in enumerate(target)
                if axes == s.partial and not cur[d]]
        if dims:
            locals_ = reduce_scatter(locals_, g, s.partial, dims[0])
            cur[dims[0]] = s.partial
        else:
            locals_ = all_reduce(locals_, g, s.partial)
    for d, axes in enumerate(cur):
        if axes and axes != target[d]:
            locals_ = all_gather(locals_, g, axes, d)
            cur[d] = ()
    for d, axes in enumerate(target):
        if axes and cur[d] != axes:
            def cut(r, xs=locals_, d=d, axes=axes):
                i, n = g.chunk(r, axes)
                size = xs[r].shape[d] // n
                return xs[r].narrow(d, i * size, size)
            locals_ = g.per_rank(cut)
            cur[d] = axes
    return Sharded(g, locals_, tuple(cur))


def gather_whole(s: Sharded) -> Sharded:
    """``s`` replicated: every rank the whole tensor."""
    return redistribute(s, ())


def reduce_over(s: Sharded, axes: tuple, *, mean: bool = False) -> Sharded:
    """Sum (or mean) of a replicated value's locals over ``axes``, each
    rank's local an addend (a per-shard loss or aux)."""
    if not axes:
        return s
    out = s.with_locals(all_reduce(s.locals, s.group, axes))
    if mean:
        n = _size(s.group, axes)
        out = out.map(lambda x: x / n)
    return out


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------
def split_tree(tree, specs, group: ShardGroup):
    """Each tensor of ``tree`` split by the spec at the same place in
    ``specs`` (a tree of ``PartitionSpec`` of the same structure)."""
    if isinstance(tree, dict):
        return {k: split_tree(v, specs[k], group) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree
    return split(tree, specs, group)


def join_tree(tree, device=None):
    """The whole tensors of a tree of :class:`Sharded`."""
    if isinstance(tree, dict):
        return {k: join_tree(v, device) for k, v in tree.items()}
    return join(tree, device)


def unbind0(s: Sharded) -> list:
    """The slices of ``s`` along its first dim, which no axis splits."""
    if s.spec[0]:
        raise ValueError(f"{s}: dim 0 is split")
    parts = s.group.map(lambda x: x.unbind(0), s)
    return [Sharded(s.group, [p[i] for p in parts], s.spec[1:])
            for i in range(len(parts[0]))]


class PeriodSlice:
    """Slice ``i`` along the first dim of a :class:`Sharded` whose first
    dim is split: only the ranks whose chunk holds ``i`` have it.
    :meth:`take` makes it on every rank (inside a period's checkpoint, so
    the stack is never gathered)."""

    __slots__ = ("s", "i")

    def __init__(self, s: Sharded, i: int):
        self.s, self.i = s, i

    @property
    def shape(self) -> torch.Size:
        return self.s.shape[1:]

    def take(self) -> Sharded:
        """The owner's slice summed with the other ranks' zeros over the
        axes that split the first dim (a broadcast from the owner, whose
        transpose returns the summed gradient to the owner's slice)."""
        s, g = self.s, self.s.group
        axes = s.spec[0]

        def mine(r):
            x = s.locals[r]
            j = self.i - g.chunk(r, axes)[0] * x.shape[0]
            # a non-owner's zeros from its own chunk, so that its trace
            # has the owner's ops and a representative rank's gradient
            # path
            return x[j] if 0 <= j < x.shape[0] else x[0] * 0
        return Sharded(g, all_reduce(g.per_rank(mine), g, axes), s.spec[1:])


def periods(s: Sharded) -> list:
    """The slices of ``s`` along its first dim: views where no axis
    splits it (:func:`unbind0`), else :class:`PeriodSlice` handles."""
    if s.spec[0]:
        return [PeriodSlice(s, i) for i in range(s.shape[0])]
    return unbind0(s)


def tree_is_sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(tree_is_sharded(v) for v in tree.values())
    return isinstance(tree, (Sharded, PeriodSlice))


def _tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, in sorted key order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _sharded_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sharded_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def replica_axes(s: Sharded) -> tuple:
    """The mesh axes along which ranks hold copies of the same chunk."""
    used = {a for axes in s.spec for a in axes}
    return tuple(a for a in s.group.axis_names if a not in used)


def value_and_grad(fn: Callable, sparams, *args, **kwargs):
    """``(out, grads)`` of ``fn(sparams, *args, **kwargs)``, whose first
    output (or only one) is a scalar tensor: the gradient of every local
    of every :class:`Sharded` leaf, summed over the ranks holding a copy of
    its chunk (:func:`replica_axes`: the data axis, and the model axis for
    a leaf the model axis does not split) in ascending rank. ``grads`` has
    the structure of ``sparams`` and its leaves' layouts; ``out`` is
    detached."""
    with torch.enable_grad():
        fresh = _tree_map(lambda s: s.with_locals(s.group.map(
            lambda x: x.detach().requires_grad_(), s)), sparams)
        out = fn(fresh, *args, **kwargs)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        flat = [s for _, s in _sharded_leaves(fresh)]
        gs = iter(torch.autograd.grad(
            loss, [s.locals[r] for s in flat for r in s.group.traced],
            materialize_grads=True))

    def reduce(s):
        g = s.group
        g_loc = g.fill({r: next(gs) for r in g.traced})
        axes = replica_axes(s)
        if not _trivial(g, axes):
            g_loc = _all_reduce_raw(g_loc, g, axes)
        return s.with_locals(g_loc)
    grads = _tree_map(reduce, fresh)
    detached = (tuple(o.detach() if isinstance(o, torch.Tensor) else o
                      for o in out) if isinstance(out, (tuple, list))
                else out.detach())
    return detached, grads


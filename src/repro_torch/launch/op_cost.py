"""Cost of one eager step, counted over its aten ops.

Counterpart of ``repro.launch.hlo_cost``. The reference parses the
optimized HLO of a compiled step; the port has no HLO, so
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten op of
one eager run, on any device (``meta`` included, where nothing is
computed) and in any thread that autograd runs the backward in:

- ``flops``: products only, ``2·|out|·K``, for ``mm``, ``addmm``, ``bmm``,
  ``baddbmm`` and ``convolution``, as the reference's ``_dot_flops`` and
  ``_conv_flops`` count ``dot`` and ``convolution`` (elementwise work is
  not the compute roofline's currency);
- ``hbm_bytes``: operands plus results of every op that is not a view or
  other bookkeeping. In eager PyTorch each such op is one round trip
  through device memory, as a fusion boundary is in XLA;
- ``peak_live_bytes``: the highest sum of live storages, the storages of
  the arguments registered at the start (:func:`analyze`) and every
  storage an op makes, each dropped when it dies (a weak reference); an
  op whose kernel allocates temporaries below the dispatcher, where no
  mode sees them, adds them to the peak by ``TRANSIENT``'s formula;
- ``launches``: the hand-written kernels, which run outside the
  dispatcher (``ctypes`` launches into ``torch.empty`` outputs) and are
  charged by formula beside their wrappers through :func:`charge`, the
  same charge whether the kernel launches on the card or is traced on
  ``meta`` (a "would launch");
- ``padded_flops``: the products a kernel spends on zero padding (head
  dim 80 padded to 128), kept out of ``flops``, which counts the true
  dims.

On a card, ``OpCounter(watch=device)`` also reads the caching
allocator's peak around every op and records, per op, the largest
allocation it made and freed inside itself (:attr:`OpCounter.hidden`):
what ``TRANSIENT`` must model for the peak on ``meta`` to be the card's.

:attr:`OpCounter.read` collects the storages the ops and kernels read (a
destination that an op only overwrites is not read), so that a dry run
can tell the arguments a step reads from those it holds unread, as a
compiled step drops an input it never reads.

The collective fields are filled by the dry run from the spec trees
(``launch/dryrun.py``): one eager process issues no collective. A loop
needs no trip count: every iteration's ops are seen.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

PRODUCTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default, aten.convolution.default}
# ops that overwrite their first argument without reading it
OVERWRITES = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
              aten.zero_.default}
# ops that move no bytes of their own: allocation, aliasing, metadata
BOOKKEEPING = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten._unsafe_view.default, aten.lift_fresh.default,
    aten._local_scalar_dense.default, aten.set_.source_Storage_storage_offset,
    aten.resize_.default, aten.sym_size.int, aten.sym_stride.int,
    aten.sym_numel.default, aten.sym_storage_offset.default,
}


def _self_bytes(args, out) -> int:
    return args[0].numel() * args[0].element_size()


# bytes an op's kernel allocates and frees inside itself, below the
# dispatcher: ATen's logsumexp takes exp(self - max) into a temporary of
# self's size before its sum
TRANSIENT = {aten.logsumexp.default: _self_bytes}


@dataclass
class CostSummary:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_link_bytes: dict = field(default_factory=dict)
    coll_counts: dict = field(default_factory=dict)
    peak_live_bytes: int = 0
    launches: dict = field(default_factory=dict)
    padded_flops: float = 0.0

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_link_bytes.values())

    def scaled(self, k: float) -> "CostSummary":
        """Every count times ``k`` (the peak stays: it is no sum)."""
        return CostSummary(
            self.flops * k, self.hbm_bytes * k,
            {kk: v * k for kk, v in self.coll_link_bytes.items()},
            {kk: v * k for kk, v in self.coll_counts.items()},
            self.peak_live_bytes,
            {kk: v * k for kk, v in self.launches.items()},
            self.padded_flops * k)

    def add(self, o: "CostSummary"):
        """Add ``o``'s counts; the peak is the larger of the two."""
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.padded_flops += o.padded_flops
        self.peak_live_bytes = max(self.peak_live_bytes, o.peak_live_bytes)
        for mine, theirs in ((self.coll_link_bytes, o.coll_link_bytes),
                             (self.coll_counts, o.coll_counts),
                             (self.launches, o.launches)):
            for kk, v in theirs.items():
                mine[kk] = mine.get(kk, 0) + v


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def product_flops(func, args, out) -> float:
    """``2·|out|·K`` of one product op; 0 for any other op."""
    if func not in PRODUCTS:
        return 0.0
    if func is aten.convolution.default:
        w = args[1]   # (out_ch, in_ch / groups, *kernel)
        return 2.0 * out.numel() * _numel(w.shape[1:])
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
        else args[0]
    return 2.0 * out.numel() * a.shape[-1]


_active: list = []             # the counters open now, in any thread
_active_lock = threading.Lock()


def charge(name: str, flops: float, reads, writes,
           padded_flops: float = 0.0) -> None:
    """Charge one launch of hand-written kernel ``name`` to every open
    :class:`OpCounter`: its products by the wrapper's formula, and the
    bytes of the tensors it ``reads`` and ``writes`` (None entries
    skipped), each once."""
    reads = [x for x in reads if x is not None]
    moved = sum(_nbytes(x) for x in reads) + sum(
        _nbytes(x) for x in writes if x is not None)
    with _active_lock:
        counters = list(_active)
    for c in counters:
        c._charge(name, flops, moved, padded_flops)
        c._read(reads)


class OpCounter(TorchDispatchMode):
    """Count the aten ops run while the mode is open into :attr:`summary`
    (see the module docstring). ``register`` the storages that live before
    the step (its arguments) so that the peak includes them."""

    def __init__(self, watch=None):
        super().__init__()
        self.summary = CostSummary()
        self.watch = None if watch is None else torch.device(watch)
        self.hidden: dict[str, int] = {}    # op -> bytes made and freed inside
        # reentrant: a storage may die, and its finalizer run, in any
        # allocation made while the lock is held
        self._lock = threading.RLock()
        self._live: dict[int, tuple] = {}   # id(storage) -> (bytes, finalizer)
        self._live_bytes = 0
        self.read: set[int] = set()         # id(storage) of what was read

    # ---------------------------------------------------------------
    def register(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live."""
        for t in _tensors(tree):
            self._track(t)
        self._peak()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            n = st.nbytes()
            self._live[key] = (n, weakref.finalize(st, self._drop, key))
            self._live_bytes += n

    def _drop(self, key: int) -> None:
        with self._lock:
            n, _ = self._live.pop(key, (0, None))
            self._live_bytes -= n

    def close(self) -> None:
        """Stop following the storages still live (their finalizers would
        keep this counter alive as long as they are)."""
        with self._lock:
            for _, fin in self._live.values():
                fin.detach()
            self._live.clear()

    def _peak(self, extra: int = 0) -> None:
        with self._lock:
            if self._live_bytes + extra > self.summary.peak_live_bytes:
                self.summary.peak_live_bytes = self._live_bytes + extra

    def _read(self, tree) -> None:
        ids = {id(t.untyped_storage()) for t in _tensors(tree)}
        with self._lock:
            self.read |= ids

    def _charge(self, name, flops, hbm_bytes, padded_flops):
        with self._lock:
            s = self.summary
            s.flops += flops
            s.hbm_bytes += hbm_bytes
            s.padded_flops += padded_flops
            s.launches[name] = s.launches.get(name, 0) + 1

    # ---------------------------------------------------------------
    def __enter__(self):
        with _active_lock:
            _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        with _active_lock:
            _active.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.watch is not None:
            torch.cuda.reset_peak_memory_stats(self.watch)
            before = torch.cuda.memory_allocated(self.watch)
        out = func(*args, **(kwargs or {}))
        if self.watch is not None:
            inside = torch.cuda.max_memory_allocated(self.watch) - max(
                before, torch.cuda.memory_allocated(self.watch))
            if inside > self.hidden.get(str(func), 0):
                self.hidden[str(func)] = inside
        flops = product_flops(func, args, out)
        moved = 0
        if not (func in BOOKKEEPING or func.is_view):
            moved = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                     + sum(_nbytes(t) for t in _tensors(out)))
            kw = {k: v for k, v in (kwargs or {}).items() if k != "out"}
            self._read((args[1:] if func in OVERWRITES else args, kw))
        with self._lock:
            self.summary.flops += flops
            self.summary.hbm_bytes += moved
        for t in _tensors(out):
            self._track(t)
        transient = TRANSIENT.get(func)
        self._peak(transient(args, out) if transient else 0)
        return out


def analyze(fn, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), CostSummary)``: one run of ``fn`` counted,
    the storages of its arguments live from the start."""
    counter = OpCounter()
    counter.register((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    counter.register(out)
    counter.close()
    return out, counter.summary

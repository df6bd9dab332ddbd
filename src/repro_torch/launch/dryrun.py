"""Dry run: trace every (arch × shape × mesh) cell on the ``meta`` device.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's step onto its production mesh with shape-only inputs and reads
XLA's memory and cost analyses. The port traces the same step eagerly on
the ``meta`` device, where nothing is allocated or computed, under
``launch/op_cost.py``'s counter, and records per device:

- the argument bytes (state or params, and the batch), from
  ``train/train_state.py``'s spec trees on any mesh, the production ones
  included;
- the traced peak of live storages (the arguments included) and the
  temporaries above the arguments (``temp_bytes``);
- the products and bytes of every aten op, the hand-written kernels
  charged by formula beside their wrappers (K1 ``4·B·H·T·S·D``, the fused
  backward ``10·B·H·T·S·D``, K4 and its backward their loops' products),
  and their launches;
- the collectives a mesh of ``dp`` replicas adds, from the spec trees: the
  gradients' all-reduce over the batch axes and the ZeRO-1 all-gather of
  each updated master chunk over its zero axes, with the reference's ring
  formulas (:func:`collective_link_bytes`, :func:`train_collectives`).

Where the mesh gives the model axis to no tensor of the step (``(1,
1)``, ``(n, 1)`` and ``pure_dp``) and splits no ZeRO-3 weight, the step
is traced at one device's share, with no ambient mesh: the batch split
over ``dp``, the ZeRO-1 chunks of the optimizer leaves at their spec-tree
shapes (the device's own chunk updated, the rest of the leaf gathered by
the all-gather counted above). Elsewhere the step, of any kind and any
input mode, runs in a shard group over the mesh's axes on ``meta``
devices (``dist/spmd.py``; ``launch.mesh.meta_mesh``), every rank's
program at its own shares, one representative rank traced where every
rank's inputs have rank 0's shapes (:func:`_lower_cell_group`): the
counter counts rank 0's share (``op_cost.OpCounter(rank=0)``) and the
group's own collectives, each charged by formula. A prefill or decode
cell's KV and Mamba caches are split there by
``train_state.cache_spec_tree``. T5 there is the decoder-only stack at
its widths, as the reference lowers it (``init_params`` and
``params_logical`` do not read ``family``).
:func:`measure_cell` runs a cell on a mesh that repeats one card, every
shard in turn: the sums over ranks of its FLOPs and launches, and its
collectives, are what the trace predicts.

The reference's ``bf16_upcast_correction`` and ``temp_tpu_est_bytes`` are
artefacts of XLA's CPU backend (f32 copies of bf16 weights that no TPU
holds) and have no counterpart: the trace allocates what the card
allocates. One count fills both of the reference's cost fields
(``flops_per_device``, its loop-blind analysis, and
``hlo_flops_per_device``, its trip-aware one): an eager trace sees every
iteration. Records go to ``experiments/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gpt-paper --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gpt-paper --shape train_4k --mesh 1x1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both|DxM]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig, ShapeSpec,
                                      cell_supported, get_arch)
from repro_torch.dist import spmd
from repro_torch.dist.sharding import (Mesh, P, axis_size, map_logical,
                                       pure_dp, set_mesh, spec_for)
from repro_torch.dist.spmd import Sharded
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_mesh, make_production_mesh, meta_mesh
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as TO
from repro_torch.train import train_state as TS
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.tree import flatten, leaves, unflatten

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
INT_BYTES = 4     # a Python int argument (step, cache_pos): the reference's int32


# ----------------------------------------------------------------------
# input specs: meta tensors (or real ones, given a device and a generator)
# ----------------------------------------------------------------------
def batch_specs(cfg: ArchConfig, shape: ShapeSpec, *, device="meta",
                gen=None):
    """(tensor tree, logical-dims tree) for one step's batch: ``meta``
    tensors by default; on another device real values drawn from ``gen``
    (tokens and labels in the vocabulary, frames and patches normal,
    positions counting up, one segment, unit loss weights), of the same
    shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def tokens(shape_):
        return torch.randint(0, cfg.vocab, shape_, generator=gen,
                             dtype=i32, device=device)

    def normal(shape_):
        return torch.randn(shape_, generator=gen, device=device).to(bf16)

    def positions(n, start=0):
        return (torch.arange(start, start + n, dtype=i32, device=device)[None]
                .expand(b, n).contiguous())

    inputs: dict = {}
    logical: dict = {}
    if shape.kind in ("train", "prefill"):
        if shape.kind == "train":
            inputs["labels"] = tokens((b, s))
            inputs["loss_weights"] = torch.ones((b, s), dtype=torch.float32,
                                                device=device)
            inputs["segment_ids"] = torch.zeros((b, s), dtype=i32,
                                                device=device)
        inputs["positions"] = positions(s)
        logical.update({k: ("dp", None) for k in inputs})
        if cfg.input_mode == "frames":
            inputs["frames"] = normal((b, s, cfg.d_model))
            inputs["mask"] = torch.rand((b, s), generator=gen,
                                        device=device) < 0.1
            logical["frames"] = ("dp", None, None)
            logical["mask"] = ("dp", None)
        elif cfg.input_mode == "mixed":
            p = cfg.n_patches
            inputs["patches"] = normal((b, p, cfg.d_model))
            inputs["tokens"] = tokens((b, s - p))
            logical["patches"] = ("dp", None, None)
            logical["tokens"] = ("dp", None)
        else:
            inputs["tokens"] = tokens((b, s))
            logical["tokens"] = ("dp", None)
        return inputs, logical

    # decode: one new token against a seq_len cache, at its last position
    inputs = {
        "tokens": tokens((b, 1)),
        "positions": positions(1, s - 1),
        "cache": T.init_cache(cfg, b, s, dtype=bf16, device=device),
        "cache_pos": s - 1,
    }
    logical = {
        "tokens": ("dp", None),
        "positions": ("dp", None),
        "cache": T.cache_logical(cfg),
        "cache_pos": (),
    }
    return inputs, logical


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def spec_tree(shapes_tree, logical_tree, mesh):
    return map_logical(lambda lg, sh: spec_for(_shape(sh), tuple(lg), mesh),
                       logical_tree, shapes_tree)


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and ints (dicts, tuples,
    lists) and the spec tree of its structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def local_shape(shape, spec: P, mesh: Mesh) -> tuple:
    """One device's share of a tensor of ``shape`` laid out by ``spec``."""
    out = []
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        n = 1
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            n *= mesh.shape[a]
        out.append(int(d) // n)
    return tuple(out)


def _localize(tree, specs, mesh):
    """The tree at one device's share, as ``meta`` tensors."""
    def loc(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.empty(local_shape(x.shape, spec, mesh), dtype=x.dtype,
                           device="meta")
    return _map(loc, tree, specs)


def _paths(tree, prefix=()):
    """``(path, leaf)`` of every tensor and int leaf of ``tree``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    elif isinstance(tree, (torch.Tensor, int)):
        yield prefix, tree


def _leaf_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return INT_BYTES


def tree_bytes(tree, paths=None) -> int:
    """Bytes of a tree's tensors, ``INT_BYTES`` for each int leaf; only
    the leaves at ``paths`` when given."""
    return sum(_leaf_bytes(x) for path, x in _paths(tree)
               if paths is None or path in paths)


# ----------------------------------------------------------------------
# step functions (they run on the card as on meta)
# ----------------------------------------------------------------------
def _chunk(spec: P, mesh: Mesh):
    """``(dim, parts)`` of a ZeRO-1 leaf's split, or None when whole."""
    for i, e in enumerate(spec):
        if e is not None:
            n = 1
            for a in (e if isinstance(e, tuple) else (e,)):
                n *= mesh.shape[a]
            return i, n
    return None


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradient (``MD.loss_fn``, the period checkpoint by
    ``cfg.remat_policy``), then AdamW in place on this device's ZeRO-1
    chunk of each leaf (the whole leaf where its zero spec is empty),
    writing the chunk's new bf16 params. The state's optimizer leaves are
    the chunks themselves (:func:`cell_arguments`)."""
    st_shapes = TS.state_shapes(cfg, opt_cfg)
    zero = TS.state_spec_tree(cfg, st_shapes, mesh)["opt"]["m"]
    chunks = [_chunk(sp, mesh) for sp in _spec_leaves(zero)]

    def train_step(state, batch):
        paths, xs = zip(*flatten(state["params"]))
        with torch.enable_grad():
            xg = [x.detach().requires_grad_() for x in xs]
            loss, _ = MD.loss_fn(unflatten(zip(paths, xg)), batch, cfg,
                                 remat=True)
            grads = torch.autograd.grad(loss, xg, materialize_grads=True)
        del xg
        opt = state["opt"]
        gnorm, scale, step, b1c, b2c = TO.step_scalars(
            unflatten(zip(paths, grads)), opt, opt_cfg)
        for p, g, m, v, ma, ch in zip(xs, grads, leaves(opt["m"]),
                                      leaves(opt["v"]), leaves(opt["master"]),
                                      chunks):
            if ch is None:
                TO._update_leaf(p, g, m, v, ma, scale, b1c, b2c, opt_cfg)
                continue
            dim, n = ch[0], m.shape[ch[0]]
            TO._update_leaf(None, g.narrow(dim, 0, n), m, v, ma, scale, b1c,
                            b2c, opt_cfg)
            p.narrow(dim, 0, n).copy_(ma)
        opt["step"] = step
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_group_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                          group: "spmd.ShardGroup"):
    """``train_step(state, batch) -> (state, metrics)`` in a shard group:
    the state's params and ``master``, ``m`` and ``v`` and the batch as
    trees of ``spmd.Sharded`` (``train_state.shard_state``,
    ``model.split_batch``); the loss and every shard's gradients
    (``spmd.value_and_grad`` of ``MD.loss_fn``), then AdamW on each
    rank's chunk (``optimizer.sharded_adamw_update``)."""
    def train_step(state, batch):
        with spmd.running(group), set_mesh(group.mesh), \
                pure_dp(cfg.pure_dp):
            loss, grads = spmd.value_and_grad(
                lambda p: MD.loss_fn(p, batch, cfg, remat=True)[0],
                state["params"])
            _, _, metrics = TO.sharded_adamw_update(
                state["params"], grads, state["opt"], opt_cfg)
        return state, {"loss": loss, "grad_norm": metrics["grad_norm"]}
    return train_step


def make_group_serve_step(cfg: ArchConfig, kind: str,
                          group: "spmd.ShardGroup"):
    """``step(params, batch) -> (logits, cache)``: ``MD.prefill`` or
    ``MD.decode`` in a shard group, the params and the batch (a decode
    batch's cache included) as trees of ``spmd.Sharded``
    (``model.shard_step_inputs``), the results as the group's."""
    serve = MD.prefill if kind == "prefill" else MD.decode

    def step(params, batch):
        with spmd.running(group), set_mesh(group.mesh), \
                pure_dp(cfg.pure_dp), torch.no_grad():
            return serve(params, batch, cfg)
    return step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            return MD.prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, batch):
        with torch.no_grad():
            return MD.decode(params, batch, cfg)
    return decode_step


# ----------------------------------------------------------------------
# collective accounting
# ----------------------------------------------------------------------
def collective_link_bytes(ops) -> dict:
    """Per-device link bytes per collective kind, from ``ops``: ``(kind,
    out_bytes, group)`` triples, each by ``op_cost.link_bytes`` (the
    reference's ring-algorithm estimates)."""
    per_kind: dict[str, float] = {}
    counts: dict[str, int] = {}
    for kind, out_bytes, g in ops:
        per_kind[kind] = per_kind.get(kind, 0.0) + op_cost.link_bytes(
            kind, out_bytes, g)
        counts[kind] = counts.get(kind, 0) + 1
    return {"link_bytes": per_kind, "counts": counts,
            "total_link_bytes": sum(per_kind.values())}


def _spec_leaves(specs) -> list:
    """The specs of a params-structured spec tree in ``flatten`` order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def train_collectives(cfg: ArchConfig, shape: ShapeSpec, mesh,
                      opt_cfg: AdamWConfig) -> list:
    """The train step's collectives, one ``(kind, out_bytes, group)`` per
    parameter leaf, as the reference's compiled step moves them: the
    gradient's all-reduce over the axes the batch is split over, in fp32
    (the optimizer's precision: the step does not compress), and, where
    ZeRO-1 splits the leaf, the all-gather of its updated fp32 master over
    its zero axes, cast to bf16 after."""
    st = TS.state_shapes(cfg, opt_cfg)
    zero = TS.state_spec_tree(cfg, st, mesh)["opt"]["m"]
    dp = _chunk(spec_for((shape.global_batch,), ("dp",), mesh), mesh)
    g_dp = dp[1] if dp else 1
    ops = []
    for p, sp in zip(leaves(st["params"]), _spec_leaves(zero)):
        if g_dp > 1:
            ops.append(("all-reduce", p.numel() * 4, g_dp))
        ch = _chunk(sp, mesh)
        if ch is not None:
            ops.append(("all-gather", p.numel() * 4, ch[1]))
    return ops


# ----------------------------------------------------------------------
# one cell
# ----------------------------------------------------------------------
def needs_group(cfg: ArchConfig, mesh) -> bool:
    """Whether a cell's step shards inside a stage on ``mesh``: its model
    axis would split a tensor, or its zero axes ZeRO-3 weights."""
    with pure_dp(cfg.pure_dp):
        return axis_size("tp", mesh) > 1 or (
            cfg.fsdp_params and axis_size("zero", mesh) > 1)


def cell_arguments(cfg: ArchConfig, shape: ShapeSpec, mesh,
                   opt_cfg: AdamWConfig) -> tuple:
    """One device's step arguments as ``meta`` tensors: ``(state, batch)``
    for a train cell, ``(params, batch)`` otherwise, each leaf at its
    spec tree's share."""
    with pure_dp(cfg.pure_dp):
        batch, blogical = batch_specs(cfg, shape)
        batch = _localize(batch, spec_tree(batch, blogical, mesh), mesh)
        if shape.kind == "train":
            st = TS.state_shapes(cfg, opt_cfg)
            return _localize(st, TS.state_spec_tree(cfg, st, mesh),
                             mesh), batch
        params = MD.init_params(torch.Generator(), cfg, device="meta")
        return _localize(params, TS.params_spec_tree(cfg, params, mesh),
                         mesh), batch


def read_paths(cfg: ArchConfig, shape: ShapeSpec,
               opt_cfg: AdamWConfig) -> set:
    """The paths (into :func:`cell_arguments`' pair) of the arguments a
    cell's step reads; a compiled step drops the others (hubert's unused
    embedding, mamba's positions, llava's patch adapter in decode), and so
    does the reference's argument size. From a ``meta`` trace at the whole
    shapes, no mesh: the step itself for prefill and decode; for train the
    loss forward without gradient (AdamW reads every optimizer leaf and
    the step count; ``compress_grads``' error feedback is not used).
    ``cache_pos`` is read where an attention layer writes its cache at
    it."""
    batch, _ = batch_specs(cfg, shape)
    params = MD.init_params(torch.Generator(), cfg, device="meta")
    head = (0, "params") if shape.kind == "train" else (0,)
    # each argument's storage object, made before the trace: an id is
    # unique only among live objects
    storages = [(head + path, x.untyped_storage())
                for path, x in _paths(params)]
    storages += [((1,) + path, x.untyped_storage())
                 for path, x in _paths(batch) if isinstance(x, torch.Tensor)]
    counter = op_cost.OpCounter()
    with torch.no_grad(), counter:
        if shape.kind == "train":
            MD.loss_fn(params, batch, cfg, remat=False)
        else:
            step_fn(cfg, shape, None, opt_cfg)(params, batch)
    counter.close()
    out = {path for path, st in storages if id(st) in counter.read}
    if shape.kind == "decode" and cfg.has_attn:
        out.add((1, "cache_pos"))
    if shape.kind == "train":
        st = TS.state_shapes(cfg, opt_cfg)
        out |= {(0, "opt", *path) for path, _ in _paths(st["opt"])
                if path[0] != "err"}
    return out


def step_fn(cfg: ArchConfig, shape: ShapeSpec, mesh, opt_cfg: AdamWConfig):
    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg, mesh)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)


class Traced:
    """One traced cell: the counter's summary (the collectives filled in)
    and its memory: the arguments the step reads, those it holds unread
    (live all the same), its outputs, those of them that are arguments
    (updated in place), and the peak of live storages, the arguments
    included. ``lower_s`` is the trace's seconds."""

    def __init__(self, summary, argument_bytes, unread_bytes, output_bytes,
                 alias_bytes, peak_bytes, lower_s):
        self.summary = summary
        self.argument_bytes = argument_bytes
        self.unread_argument_bytes = unread_bytes
        self.output_bytes = output_bytes
        self.alias_bytes = alias_bytes
        self.peak_bytes = peak_bytes
        self.temp_bytes = peak_bytes - argument_bytes - unread_bytes
        self.lower_s = lower_s


def _storages(tree) -> set:
    return {id(x.untyped_storage()) for _, x in _paths(tree)
            if isinstance(x, torch.Tensor)}


def group_arguments(cfg: ArchConfig, shape: ShapeSpec, mesh,
                    opt_cfg: AdamWConfig, group: "spmd.ShardGroup") -> tuple:
    """A cell's ``(state, batch)`` (train) or ``(params, batch)`` (prefill
    and decode, the cache in the batch) as trees of ``spmd.Sharded`` over
    ``group``'s ``meta`` devices, each rank's local at its spec tree's
    share (the step count and ``cache_pos`` ints)."""
    with pure_dp(cfg.pure_dp):
        batch, blogical = batch_specs(cfg, shape)
        bspecs = spec_tree(batch, blogical, mesh)
        if shape.kind == "train":
            st = TS.state_shapes(cfg, opt_cfg)
            sspecs = TS.state_spec_tree(cfg, st, mesh)
        else:
            st = MD.init_params(torch.Generator(), cfg, device="meta")
            sspecs = TS.params_spec_tree(cfg, st, mesh)

    def make(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        loc = local_shape(x.shape, spec, mesh)
        return Sharded(group, group.per_rank(lambda r: torch.empty(
            loc, dtype=x.dtype, device="meta")), spec)
    return _map(make, st, sspecs), _map(make, batch, bspecs)


def uniform_shares(tree) -> bool:
    """Whether every rank's local of every leaf has rank 0's shape (a
    representative rank then stands for all)."""
    for _, s in spmd._sharded_leaves(tree):
        if isinstance(s, Sharded):
            g = s.group
            sizes = {tuple(n for _, _, n in spmd._chunk_slices(
                g, r, s.spec, s.shape)) for r in range(g.n)}
            if len(sizes) > 1:
                return False
    return True


def _lower_cell_group(cfg: ArchConfig, shape: ShapeSpec, mesh,
                      opt_cfg: AdamWConfig, *,
                      representative: bool = None) -> Traced:
    """A cell traced in a shard group over ``mesh``'s axes on ``meta``
    (see the module docstring): one representative rank where
    :func:`uniform_shares` holds (``representative`` forces the choice),
    else every rank; the counts are rank 0's."""
    t0 = time.perf_counter()
    args = cell_arguments(cfg, shape, mesh, opt_cfg)
    all_bytes = tree_bytes(args)
    read_bytes = tree_bytes(args, read_paths(cfg, shape, opt_cfg))
    ints = sum(INT_BYTES for _, x in _paths(args)
               if not isinstance(x, torch.Tensor))
    mm = meta_mesh(mesh)
    if representative is None:
        probe = spmd.ShardGroup(mm, representative=True)
        representative = uniform_shares(dict(zip(
            "sb", group_arguments(cfg, shape, mesh, opt_cfg, probe))))
    group = spmd.ShardGroup(mm, representative=representative)
    state, batch = group_arguments(cfg, shape, mesh, opt_cfg, group)
    fn = (make_group_train_step(cfg, opt_cfg, group)
          if shape.kind == "train"
          else make_group_serve_step(cfg, shape.kind, group))
    counter = op_cost.OpCounter(rank=0)
    for r in group.traced:
        counter.register(spmd.local((state, batch), r), rank=r)
    held = _storages(spmd.local(state, 0))
    with counter:
        out = fn(state, batch)
    counter.close()
    mine = spmd.local(out, 0)
    alias = sum(_leaf_bytes(x) for _, x in _paths(mine)
                if isinstance(x, torch.Tensor)
                and id(x.untyped_storage()) in held)
    return Traced(counter.summary, read_bytes, all_bytes - read_bytes,
                  tree_bytes(mine), alias,
                  counter.summary.peak_live_bytes + ints,
                  time.perf_counter() - t0)


def _lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
                opt_cfg: AdamWConfig) -> Traced:
    """Trace one cell's step on ``meta`` at one device's share of ``mesh``
    (see the module docstring)."""
    if needs_group(cfg, mesh):
        return _lower_cell_group(cfg, shape, mesh, opt_cfg)
    t0 = time.perf_counter()
    args = cell_arguments(cfg, shape, mesh, opt_cfg)
    all_bytes = tree_bytes(args)
    read_bytes = tree_bytes(args, read_paths(cfg, shape, opt_cfg))
    ints = sum(INT_BYTES for _, x in _paths(args)
               if not isinstance(x, torch.Tensor))
    held = _storages(args)
    with pure_dp(cfg.pure_dp):
        fn = step_fn(cfg, shape, mesh, opt_cfg)
    counter = op_cost.OpCounter()
    counter.register(args)
    with pure_dp(cfg.pure_dp), counter:
        out = fn(*args)
    counter.register(out)
    counter.close()
    summary = counter.summary
    if shape.kind == "train":
        coll = collective_link_bytes(
            train_collectives(cfg, shape, mesh, opt_cfg))
        summary.coll_link_bytes = coll["link_bytes"]
        summary.coll_counts = coll["counts"]
    alias = sum(_leaf_bytes(x) for _, x in _paths(out)
                if isinstance(x, torch.Tensor)
                and id(x.untyped_storage()) in held)
    return Traced(summary, read_bytes, all_bytes - read_bytes,
                  tree_bytes(out), alias, summary.peak_live_bytes + ints,
                  time.perf_counter() - t0)


def measure_cell(cfg: ArchConfig, shape: ShapeSpec, *, device="cuda",
                 seed: int = 0, opt_cfg: AdamWConfig = None,
                 mesh_shape: tuple = None) -> dict:
    """Run a cell's step on one card, as the dry run traces it on a (1, 1)
    mesh, with weights and a batch drawn there from ``seed``: once under
    the ``op_cost`` counter (FLOPs, the kernels' charged launches, and the
    allocator's peak inside each op), then once more, timed by CUDA events,
    with the peak of ``torch.cuda.max_memory_allocated`` above what was
    allocated before the arguments were made. Returns ``{"flops",
    "launches", "counted", "hidden", "peak_bytes", "step_ms", "finite",
    "collectives", "link_bytes"}``: ``counted`` the kernels' own launch
    counts in the first run, the collectives the shard group's
    (``spmd.collective_counts`` and ``collective_link_bytes``).

    With ``mesh_shape`` the step runs in a shard group over a (data,
    model) mesh of that shape that repeats ``device``
    (:func:`make_group_train_step`, :func:`make_group_serve_step`, the
    arguments split before): every shard in turn, so the counts are sums
    over the ranks, and the peak is the card's, which holds every shard
    (no one device's)."""
    from repro_torch.kernels import ops
    opt_cfg = opt_cfg or AdamWConfig()
    device = torch.device(device)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if shape.kind == "train":
        first = TS.init_state(gen, cfg, opt_cfg, device=device)
    else:
        first = MD.init_params(gen, cfg, device=device)
    batch, _ = batch_specs(cfg, shape, device=device, gen=gen)
    if mesh_shape is None:
        fn = step_fn(cfg, shape, parse_mesh("1x1"), opt_cfg)
    else:
        n = 1
        for k in mesh_shape:
            n *= k
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"),
                         devices=[device] * n)
        group = spmd.ShardGroup(mesh)
        with pure_dp(cfg.pure_dp), set_mesh(mesh):
            if shape.kind == "train":
                first = TS.shard_state(first, cfg, mesh)
                batch = MD.split_batch(batch, group)
                fn = make_group_train_step(cfg, opt_cfg, group)
            else:
                first, batch = MD.shard_step_inputs(first, batch, cfg, group)
                fn = make_group_serve_step(cfg, shape.kind, group)
    ops.reset_launch_counts()
    spmd.reset_collective_counts()
    counter = op_cost.OpCounter(watch=device)
    with counter:
        out = fn(first, batch)
    counter.close()
    counted = {k: n for k, n in ops.launch_counts().items() if n}
    coll = {k.replace("_", "-"): n
            for k, n in spmd.collective_counts().items() if n}
    link = {k.replace("_", "-"): v
            for k, v in spmd.collective_link_bytes().items() if v}
    del out
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(first, batch)
    end.record()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    head = out[1]["loss"] if shape.kind == "train" else out[0]
    finite = all(bool(torch.isfinite(x).all()) for x in (
        head.locals if isinstance(head, Sharded) else [head]))
    del out, first, batch
    return {"flops": counter.summary.flops,
            "launches": dict(counter.summary.launches), "counted": counted,
            "hidden": counter.hidden, "peak_bytes": peak,
            "step_ms": start.elapsed_time(end), "finite": finite,
            "collectives": coll, "link_bytes": link}


def mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def parse_mesh(text: str):
    """``"single"``/``"multi"``: the production meshes; ``"DxM"``: an
    abstract data x model mesh of those sizes."""
    if text in ("single", "multi"):
        return make_production_mesh(multi_pod=text == "multi")
    data, model = (int(x) for x in text.lower().split("x"))
    return Mesh(None, ("data", "model"), axis_sizes=(data, model))


def _cost(tr: Traced) -> dict:
    s = tr.summary
    return {
        "flops_per_device": s.flops,
        "bytes_per_device": s.hbm_bytes,
        "hlo_flops_per_device": s.flops,
        "hlo_hbm_bytes_per_device": s.hbm_bytes,
        "padded_flops_per_device": s.padded_flops,
        "launches": dict(s.launches),
    }


def _collectives(tr: Traced) -> dict:
    s = tr.summary
    return {"link_bytes": dict(s.coll_link_bytes),
            "counts": dict(s.coll_counts),
            "total_link_bytes": s.total_coll_bytes}


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = True,
             verbose: bool = True, *, mesh=None, cfg: ArchConfig = None,
             shape: ShapeSpec = None, out_dir: Path = None) -> dict:
    """Trace one cell and return its record (saved as JSON under
    ``out_dir``). ``mesh``, ``cfg`` and ``shape`` replace the production
    mesh, ``get_arch(arch)`` and ``SHAPES[shape_name]``."""
    cfg = cfg if cfg is not None else get_arch(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    ok, why = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag(mesh),
           "runnable": ok, "skip_reason": why if not ok else ""}
    if not ok:
        return rec
    n_chips = 1
    for n in mesh.shape.values():
        n_chips *= n
    opt_cfg = AdamWConfig()
    rec["n_chips"] = n_chips
    rec["model"] = {"n_params": cfg.n_params(),
                    "n_params_active": cfg.n_params_active()}
    tr = _lower_cell(cfg, shape, mesh, opt_cfg)
    rec.update({
        "lower_s": round(tr.lower_s, 1),
        "compile_s": 0.0,
        "memory": {
            "argument_bytes": tr.argument_bytes,
            "unread_argument_bytes": tr.unread_argument_bytes,
            "output_bytes": tr.output_bytes,
            "temp_bytes": tr.temp_bytes,
            "peak_bytes": tr.peak_bytes,
            "alias_bytes": tr.alias_bytes,
            "device_bytes_est": tr.peak_bytes,
        },
        "cost": _cost(tr),
        "collectives": _collectives(tr),
        "collectives_trip_aware": _collectives(tr),
    })
    if save:
        out_dir = Path(out_dir) if out_dir is not None else OUT_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape_name}__{rec['mesh']}.json"
        (out_dir / tag).write_text(json.dumps(rec, indent=1))
    if verbose:
        c = rec["cost"]
        print(f"[OK] {arch:26s} {shape_name:12s} {rec['mesh']:8s} "
              f"mem/dev≈{rec['memory']['peak_bytes'] / 1e9:6.2f}GB  "
              f"flops/dev={c['flops_per_device']:.3e}  "
              f"hbm={c['bytes_per_device']:.3e}B "
              f"coll={rec['collectives']['total_link_bytes']:.3e}B  "
              f"launches={c['launches']}  (trace {tr.lower_s:.0f}s)",
              flush=True)
    return rec


def reanalyze_cell(arch: str, shape_name: str, multi_pod: bool, *,
                   mesh=None, out_dir: Path = None) -> None:
    """Trace again and refresh the cost and collective fields of an
    existing record (when the counter or a kernel's charge changes)."""
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    path = (Path(out_dir) if out_dir is not None else OUT_DIR) / (
        f"{arch}__{shape_name}__{mesh_tag(mesh)}.json")
    rec = json.loads(path.read_text())
    if not rec.get("runnable") or rec.get("cost") is None:
        return
    tr = _lower_cell(get_arch(arch), SHAPES[shape_name], mesh, AdamWConfig())
    rec["cost"] = _cost(tr)
    rec["collectives"] = rec["collectives_trip_aware"] = _collectives(tr)
    path.write_text(json.dumps(rec, indent=1))
    print(f"[reanalyzed] {path.name}: flops={tr.summary.flops:.3e} "
          f"hbm={tr.summary.hbm_bytes:.3e} "
          f"coll={tr.summary.total_coll_bytes:.3e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single | multi | both (the production meshes) or "
                         "DxM, a data x model mesh such as 1x1 or 8x1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the records")
    args = ap.parse_args(argv)

    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    meshes = [(n == "multi", parse_mesh(n)) for n in names]
    archs = ARCH_IDS[:10] if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    out_dir = Path(args.out)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp, mesh in meshes:
                tag = f"{arch}__{shape}__{mesh_tag(mesh)}.json"
                if args.skip_existing and (out_dir / tag).exists():
                    print(f"[skip existing] {tag}", flush=True)
                    continue
                try:
                    if args.reanalyze:
                        reanalyze_cell(arch, shape, mp, mesh=mesh,
                                       out_dir=out_dir)
                        continue
                    run_cell(arch, shape, mp, mesh=mesh, out_dir=out_dir)
                except Exception as e:
                    failures.append((arch, shape, mesh_tag(mesh), repr(e)))
                    print(f"[FAIL] {arch} {shape} {mesh_tag(mesh)}: {e}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print("  ", f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()

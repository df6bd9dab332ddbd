"""The training state tree and its logical sharding trees (DP/TP/SP and
ZeRO-1), counterpart of ``repro.train.train_state``.

:func:`shard_params` splits a parameter tree by :func:`params_spec_tree`
over a mesh with devices into a tree of ``spmd.Sharded`` leaves, each
rank holding only its slice (the shapes of the reference's
``addressable_shards`` under the same mesh), and :func:`join_params`
joins it back.

``state_shapes`` builds the state on the ``meta`` device in place of
``jax.eval_shape``: shapes and dtypes, nothing allocated, so the full tree
of the largest arch costs nothing. The spec trees read only a mesh's axis
names and sizes, so an abstract mesh (``launch.mesh.make_production_mesh``)
serves as well as one with devices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import spmd
from repro_torch.dist.sharding import (P, Mesh, map_logical, spec_for,
                                       spec_for_zero, zero1_logical)
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def init_state(gen: torch.Generator, cfg: ArchConfig, opt_cfg: AdamWConfig,
               device="cuda"):
    params = MD.init_params(gen, cfg, device=device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def state_shapes(cfg: ArchConfig, opt_cfg: AdamWConfig):
    """The state tree as ``meta`` tensors (the optimizer's ``step`` an
    int), without allocating."""
    return init_state(torch.Generator(), cfg, opt_cfg, device="meta")


def _param_spec(cfg: ArchConfig, shape, logical, mesh):
    """bf16 compute-param spec; the ZeRO-3 (FSDP) upgrade for
    ``fsdp_params`` archs."""
    if cfg.fsdp_params:
        zlg = zero1_logical(tuple(logical), tuple(shape), mesh)
        return spec_for_zero(tuple(shape), zlg, mesh)
    return spec_for(tuple(shape), tuple(logical), mesh)


def params_spec_tree(cfg: ArchConfig, params_shapes, mesh):
    return map_logical(lambda lg, sh: _param_spec(cfg, sh.shape, lg, mesh),
                       MD.params_logical(cfg), params_shapes)


def cache_spec_tree(cfg: ArchConfig, cache_shapes, mesh):
    """PartitionSpec tree of a serving cache (``transformer.init_cache``'s
    tuple of dicts of tensors, ``Sharded`` values or shape tuples) from
    ``transformer.cache_logical``, as the reference
    places it (``src/repro/models/transformer.py:99-115``): the KV cache's
    rows over dp and its sequence over the model axis, Mamba's conv
    channels and ssm heads over tp; a dim the axes do not divide stays
    whole."""
    return map_logical(lambda lg, sh: spec_for(tuple(getattr(sh, "shape",
                                                             sh)), lg, mesh),
                       T.cache_logical(cfg), cache_shapes)


def shard_cache(cache, cfg: ArchConfig, group: "spmd.ShardGroup"):
    """A whole cache split by :func:`cache_spec_tree` over ``group``'s
    ranks (a cache that comes split as it is)."""
    specs = cache_spec_tree(cfg, cache, group.mesh)
    return tuple({k: v if isinstance(v, spmd.Sharded)
                  else spmd.split(v, sp[k], group) for k, v in lc.items()}
                 for lc, sp in zip(cache, specs))


def shard_params(params, cfg: ArchConfig, mesh: Mesh):
    """``params`` split over ``mesh``'s devices by
    :func:`params_spec_tree`: a tree of ``spmd.Sharded``. ZeRO-3 weights
    (``fsdp_params``) are stored by their ZeRO spec, as the reference's
    ``_param_spec`` places them; the stack gathers each period's to the
    plain-TP layout where it runs (``transformer._pin_fsdp``)."""
    return spmd.split_tree(params, params_spec_tree(cfg, params, mesh),
                           spmd.ShardGroup(mesh))


def join_params(sparams, device=None):
    """The whole tree of a :func:`shard_params` tree (or of its
    gradients), on ``device`` (rank 0's by default)."""
    return spmd.join_tree(sparams, device)


def state_spec_tree(cfg: ArchConfig, st_shapes, mesh):
    """PartitionSpec tree of the whole train state, ZeRO-1 on the
    optimizer leaves."""
    logical = MD.params_logical(cfg)
    params = st_shapes["params"]

    def zspec(lg, sh):
        zlg = zero1_logical(tuple(lg), tuple(sh.shape), mesh)
        return spec_for_zero(tuple(sh.shape), zlg, mesh)

    zero = map_logical(zspec, logical, params)
    opt = {"step": P(), "master": zero, "m": zero, "v": zero}
    if "err" in st_shapes["opt"]:
        opt["err"] = map_logical(
            lambda lg, sh: spec_for(tuple(sh.shape), tuple(lg), mesh),
            logical, params)
    return {"params": params_spec_tree(cfg, params, mesh), "opt": opt}


def shard_state(state, cfg: ArchConfig, mesh: Mesh):
    """A whole train state split over ``mesh``'s devices by
    :func:`state_spec_tree`: the params as :func:`shard_params` splits
    them, ``master``, ``m`` and ``v`` by their ZeRO-1 specs, the step
    as it is (``optimizer.sharded_adamw_update`` takes it)."""
    group = spmd.ShardGroup(mesh)
    specs = state_spec_tree(cfg, state, mesh)
    opt = {"step": state["opt"]["step"]}
    for k in ("master", "m", "v"):
        opt[k] = spmd.split_tree(state["opt"][k], specs["opt"][k], group)
    return {"params": spmd.split_tree(state["params"], specs["params"],
                                      group), "opt": opt}

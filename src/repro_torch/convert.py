"""Carry a parameter tree from the JAX reference into the port.

``params_from_jax`` takes the tree of ``repro.models.model.init_params`` (or
a checkpoint) as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``,
and returns the same nested dict of torch tensors on ``device``. bf16 arrays
arrive as ``ml_dtypes.bfloat16``; their bits are reinterpreted, so no
``ml_dtypes`` import is needed and no value changes.
:func:`sharded_params_from_jax` splits the result over a mesh's devices
as ``train_state.shard_params`` does, so that the reference's tree feeds a
shard group.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")     # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    tensors on ``device``."""
    device = resolve_device(device)

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return _tensor(x, device)

    return go(tree)


def sharded_params_from_jax(tree, cfg, mesh):
    """:func:`params_from_jax` onto the CPU, then split over ``mesh``'s
    devices by the params' spec tree: a tree of ``spmd.Sharded``."""
    from repro_torch.train.train_state import shard_params
    return shard_params(params_from_jax(tree, device="cpu"), cfg, mesh)

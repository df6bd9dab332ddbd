"""The period checkpoint's three policies (ROADMAP A20) against the
reference's.

The reference's ``test_remat_policy_loss_unchanged``
(``tests/test_perf_variants.py``) on the port: reduced starcoder2-7b, the
reference's weights carried across, one batch; the loss is the same under
"nothing", "dots" and "everything" and equal to the reference's, and the
gradients of "nothing" and "dots" are equal to the bit on the CPU. "dots"
(``models/transformer.py::dots_policy``) saves the outputs of the
products without batch dims and nothing else: ``aten.mm`` in the forward,
no ``bmm`` (attention's plain version on the CPU, the experts of an MoE
layer) and no allocation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import repro  # noqa: F401  (the reference's jax compat shims)
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.models import model as JM
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten, unflatten

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
POLICIES = ("nothing", "dots", "everything")


def _batch(cfg):
    k1, k2 = jax.random.split(jax.random.fold_in(KEY, 4))
    return {
        "tokens": np.asarray(jax.random.randint(k1, (2, 32), 0, cfg.vocab)),
        "labels": np.asarray(jax.random.randint(k2, (2, 32), 0, cfg.vocab)),
        "loss_weights": np.ones((2, 32), np.float32),
        "positions": np.broadcast_to(np.arange(32, dtype=np.int32)[None],
                                     (2, 32)).copy(),
        "segment_ids": np.zeros((2, 32), np.int32),
    }


def _port_loss_and_grads(params, batch, cfg):
    paths, xs = zip(*flatten(params))
    xs = [x.detach().requires_grad_() for x in xs]
    loss, _ = TM.loss_fn(unflatten(zip(paths, xs)), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, xs)


def _setup(arch, dtype="bfloat16"):
    jcfg = dataclasses.replace(j_reduced(j_get_arch(arch)), dtype=dtype)
    jparams = jax.jit(JM.init_params, static_argnums=1)(KEY, jcfg)
    batch = _batch(jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    return (jcfg, jparams, batch,
            dataclasses.replace(reduced(get_arch(arch)), dtype=dtype),
            tparams, tbatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policy_loss_unchanged(dtype):
    """Against the reference within its 1e-5 in fp32; in bf16, the
    reference's own dtype, within the bf16 rounding of the two stacks'
    different sums."""
    jcfg, jparams, batch, cfg, tparams, tbatch = _setup("starcoder2-7b",
                                                        dtype)
    tol = 1e-5 if dtype == "float32" else 2e-3
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, grads = {}, {}
    for pol in POLICIES:
        (jl, _), _ = jax.value_and_grad(
            lambda p, c=dataclasses.replace(jcfg, remat_policy=pol):
            JM.loss_fn(p, jb, c), has_aux=True)(jparams)
        tl, g = _port_loss_and_grads(
            tparams, tbatch, dataclasses.replace(cfg, remat_policy=pol))
        assert np.isfinite(float(tl))
        assert abs(float(tl) - float(jl)) < tol, (pol, float(tl), float(jl))
        losses[pol], grads[pol] = float(tl), g
    assert max(losses.values()) - min(losses.values()) < 1e-5
    for a, b in zip(grads["nothing"], grads["dots"]):
        assert torch.equal(a, b)
    for a, b in zip(grads["nothing"], grads["everything"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-moe-3b-a800m"])
def test_dots_saves_the_weight_products_only(arch, monkeypatch):
    *_, cfg, tparams, tbatch = _setup(arch)
    decisions = []
    policy = TT.dots_policy

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, out))
        return out

    monkeypatch.setattr(TT, "dots_policy", recording)
    _port_loss_and_grads(tparams, tbatch,
                         dataclasses.replace(cfg, remat_policy="dots"))
    saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    ops = {op for op, _ in decisions}
    assert torch.ops.aten.bmm.default in ops       # seen, and recomputed
    assert set(saved) == {torch.ops.aten.mm.default}
    # every weight product of every layer: q, k, v, o, the MLP's (or the
    # router's and the shared expert's) matmuls
    per_layer = {"starcoder2-7b": 6, "granite-moe-3b-a800m": 5}[arch]
    assert len(saved) == per_layer * cfg.n_layers


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(reduced(get_arch("gpt-paper")),
                              remat_policy="offload")
    params = TM.init_params(torch.Generator(), cfg, device="cpu")
    batch = {k: torch.from_numpy(v.copy()) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="offload"):
        TM.loss_fn(params, batch, cfg)

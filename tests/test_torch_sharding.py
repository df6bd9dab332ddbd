"""The port's logical-axis sharding rules against the JAX reference's.

Specs: ``spec_for``, ``zero1_logical``, ``spec_for_zero``, ``axis_map`` and
``axis_size`` over four meshes, (4,) stage, (2, 4) data x model, (16, 16)
and (2, 16, 16) pod x data x model, with ``pure_dp`` off and on, for every
parameter leaf of every arch at full size and for activation-style
logical tuples at sizes that do and do not divide. The reference reads a
``jax.sharding.AbstractMesh`` (no devices), the port its abstract
``Mesh``. Trees: ``params_logical`` for every arch, and ``state_spec_tree``
/ ``params_spec_tree`` at both production meshes for every arch at full
size, the port's shapes from the ``meta`` device against
``jax.eval_shape``'s. Every comparison is exact. Then sharding inside a
stage: on a (2, 2) data x model mesh ``shard`` inside a shard group
changes the layout and ``moe_fwd`` computes, while ``shard`` on a tensor
outside a group, ``moe_fwd`` on an abstract mesh and ``_pin_fsdp`` raise,
naming the shard group, the one place the port splits inside a stage; a
stage-only mesh leaves the forward as it is. The
shard group's parity with the reference is ``tests/test_torch_spmd.py``.
"""
import functools

import jax  # noqa: F401  (JAX beside torch, on the CPU)
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import _jax_compat
from repro.configs.base import ARCH_IDS, get_arch as j_get_arch
from repro.dist import sharding as JS
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.models import transformer as JT
from repro.train import train_state as JTS
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs.base import get_arch, reduced
from repro_torch.dist import sharding as TS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.train import train_state as TTS
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.tree import flatten

torch.set_num_threads(1)

MESHES = {"stage4": ((4,), ("stage",)),
          "data2-model4": ((2, 4), ("data", "model")),
          "prod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# activation-style tuples (the models' shard calls and cache trees) at
# sizes that divide every axis, some, and none
ACTIVATIONS = [
    ((256, 4096, 4096), ("dp", "sp", None)),
    ((1, 1, 4096), ("dp", "sp", None)),
    ((6, 3, 40, 128), ("dp", None, "tp", None)),
    ((32, 2048, 8, 128), ("dp", "sp", None, None)),
    ((40, 64, 512), ("ep", None, "tp")),
    ((64, 4096, 1536), ("ep", None, "tp")),
    ((4, 32, 2048, 8, 128), (None, "dp", "sp", None, None)),
    ((12, 4096), ((("tp", "zero")), None)),
    ((512, 48), ("zero", "dp")),
]


def _meshes(name):
    sizes, names = MESHES[name]
    return (AbstractMesh(sizes, names),
            TS.Mesh(None, names, axis_sizes=sizes))


@functools.lru_cache(maxsize=None)
def _leaf_cases():
    """(shape, logical) of every parameter leaf of every arch at full
    size: the port's meta shapes, the reference's logical tree."""
    out = []
    for arch in ARCH_IDS:
        shapes = dict(flatten(TM.init_params(torch.Generator(),
                                             get_arch(arch), device="meta")))
        for path, lg in _logical_leaves(JM.params_logical(j_get_arch(arch))):
            out.append((tuple(shapes[path].shape), lg))
    return tuple(out)


def _logical_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _logical_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _specs(tree, prefix=()):
    """path -> spec as a tuple, of a tree of dicts and specs."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_specs(tree[k], prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("pure", [False, True], ids=["sharded", "pure_dp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolution_matches_reference(mesh_name, pure):
    jmesh, tmesh = _meshes(mesh_name)
    with JS.pure_dp(pure), TS.pure_dp(pure):
        assert TS.axis_map(tmesh) == JS.axis_map(jmesh)
        for name in ("dp", "tp", "sp", "ep", "zero", "other"):
            assert TS.axis_size(name, tmesh) == JS.axis_size(name, jmesh)
        cases = list(_leaf_cases()) + ACTIVATIONS
        for shape, lg in cases:
            got = TS.spec_for(shape, lg, tmesh)
            assert isinstance(got, TS.PartitionSpec)
            assert got == tuple(JS.spec_for(shape, lg, jmesh)), (shape, lg)
            zl = TS.zero1_logical(lg, shape, tmesh)
            assert zl == JS.zero1_logical(lg, shape, jmesh), (shape, lg)
            assert TS.spec_for_zero(shape, zl, tmesh) == tuple(
                JS.spec_for_zero(shape, zl, jmesh)), (shape, lg)
    # no mesh: no constraint
    assert TS.spec_for((8, 8), ("dp", "tp")) == () == TS.P()
    assert TS.zero1_logical((None, "tp"), (8, 8)) == (None, "tp")
    assert TS.axis_size("tp") == 1 and TS.axis_map() == {}


def test_params_logical_matches_reference_for_every_arch():
    for arch in ARCH_IDS:
        assert TM.params_logical(get_arch(arch)) == \
            JM.params_logical(j_get_arch(arch)), arch
        assert TT.cache_logical(get_arch(arch)) == \
            JT.cache_logical(j_get_arch(arch)), arch


def test_heads_even_and_tp_ok_follow_the_ambient_mesh():
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        with _jax_compat._recording_set_mesh(jmesh), TS.set_mesh(tmesh):
            assert TS.ambient_mesh() is tmesh
            for arch in ARCH_IDS:
                assert TL.heads_even(get_arch(arch)) == \
                    JL.heads_even(j_get_arch(arch)), (name, arch)
                assert TMB._tp_ok(get_arch(arch)) == \
                    JMB._tp_ok(j_get_arch(arch)), (name, arch)
    assert TS.ambient_mesh() is None


@functools.lru_cache(maxsize=None)
def _state_shapes(arch):
    return (JTS.state_shapes(j_get_arch(arch), JAdamWConfig()),
            TTS.state_shapes(get_arch(arch), AdamWConfig()))


def test_state_shapes_match_eval_shape_for_every_arch():
    for arch in ARCH_IDS:
        jst, tst = _state_shapes(arch)
        ref = dict(flatten(jst))
        got = dict(flatten(tst))
        assert sorted(got) == sorted(ref), arch
        for path, x in got.items():
            r = ref[path]
            if path == ("opt", "step"):
                assert x == 0 and r.shape == () and r.dtype == np.int32
                continue
            assert x.device.type == "meta", (arch, path)
            assert tuple(x.shape) == tuple(r.shape), (arch, path)
            assert str(x.dtype).removeprefix("torch.") == str(r.dtype), \
                (arch, path)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_spec_trees_match_reference_for_every_arch(multi_pod):
    sizes, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    jmesh = AbstractMesh(sizes, names)
    tmesh = make_production_mesh(multi_pod=multi_pod)
    assert tmesh.devices is None and tmesh.shape == dict(zip(names, sizes))
    for arch in ARCH_IDS:
        jcfg, tcfg = j_get_arch(arch), get_arch(arch)
        jst, tst = _state_shapes(arch)
        assert _specs(TTS.state_spec_tree(tcfg, tst, tmesh)) == _specs(
            JTS.state_spec_tree(jcfg, jst, jmesh)), arch
        assert _specs(TTS.params_spec_tree(tcfg, tst["params"], tmesh)) == \
            _specs(JTS.params_spec_tree(jcfg, jst["params"], jmesh)), arch


@pytest.mark.parametrize("part", ["shard-outside-a-group",
                                  "shard-inside-a-group",
                                  "moe-under-a-model-axis",
                                  "moe-on-an-abstract-mesh",
                                  "pin-fsdp"])
def test_sharding_inside_a_stage_raises_a23(part):
    """What sharding inside a stage computes and what raises: ``shard``
    on a tensor outside a shard group, ``moe_fwd`` on an abstract mesh and
    ``_pin_fsdp`` raise, naming the shard group (the port splits inside a
    stage only there; the model's entry points open one); ``shard`` inside
    a group changes the layout, and ``moe_fwd`` under a model axis with
    devices computes."""
    dm = TS.Mesh(None, ("data", "model"), axis_sizes=(2, 2))
    x = torch.zeros(4, 8, 16)
    if part == "shard-outside-a-group":
        assert TS.shard(x, "dp", "sp", None) is x               # no mesh
        with TS.set_mesh(dm):
            with pytest.raises(NotImplementedError, match="shard group"):
                TS.shard(x, "dp", "sp", None)
            # a dim that no axis divides is replicated: nothing to split
            assert TS.shard(torch.zeros(3, 5), "dp", "sp") is not None
        with pytest.raises(NotImplementedError, match="shard group"):
            TS.shard(x, "dp", None, None, mesh=dm)
    elif part == "shard-inside-a-group":
        from repro_torch.dist import spmd
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
        g = spmd.ShardGroup(mesh)
        y = torch.arange(4 * 8 * 16, dtype=torch.float32).reshape(4, 8, 16)
        with spmd.running(g), TS.set_mesh(mesh):
            s = TS.shard(spmd.split(y, (), g), "dp", "sp", None)
            assert s.pspec == TS.P("data", "model")
            assert [tuple(v.shape) for v in s.locals] == [(2, 4, 16)] * 4
            assert torch.equal(s.locals[3], y[2:, 4:])
            assert torch.equal(spmd.join(s), y)
    elif part == "moe-under-a-model-axis":
        from repro_torch.launch.mesh import make_mesh
        gen = torch.Generator().manual_seed(0)
        moe = reduced(get_arch("granite-moe-3b-a800m"))
        p = TL.init_moe(gen, moe, "cpu")
        h = torch.randn(2, 8, moe.d_model, generator=gen).to(torch.bfloat16)
        y, _ = TL.moe_fwd(p, h, moe)                              # no mesh
        mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
        with TS.set_mesh(mesh):
            ys, aux = TL.moe_fwd(p, h, moe)
        # one data shard: the same tokens and capacity, experts split in
        # two; the partial outputs are summed, then the sum is rounded
        assert ys.shape == y.shape and ys.dtype == y.dtype
        assert torch.isfinite(aux)
        torch.testing.assert_close(ys.float(), y.float(), atol=2e-2,
                                   rtol=2e-2)
    elif part == "moe-on-an-abstract-mesh":
        gen = torch.Generator().manual_seed(0)
        moe = reduced(get_arch("granite-moe-3b-a800m"))
        p = TL.init_moe(gen, moe, "cpu")
        h = torch.randn(2, 8, moe.d_model, generator=gen).to(torch.bfloat16)
        with TS.set_mesh(dm), pytest.raises(NotImplementedError,
                                            match="shard group"):
            TL.moe_fwd(p, h, moe)
    else:
        fsdp = reduced(get_arch("qwen1.5-110b"))
        assert fsdp.fsdp_params
        w = {"w": torch.zeros(2)}
        assert TT._pin_fsdp(w, fsdp) is w                     # no mesh
        with TS.set_mesh(dm), pytest.raises(NotImplementedError,
                                            match="shard group"):
            TT._pin_fsdp(w, fsdp)


def test_a_stage_only_mesh_leaves_the_forward_as_it_is():
    """On a (4,) stage mesh no activation resolves to an axis (dp, tp, sp
    and ep name none of it), so the forward runs, equal to the bit to the
    forward with no mesh."""
    cfg = reduced(get_arch("gpt-paper"))
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab, (2, 16))),
             "positions": torch.arange(16).repeat(2, 1),
             "segment_ids": torch.zeros(2, 16, dtype=torch.int32)}
    h, _, _ = TM.forward(params, batch, cfg)
    with TS.set_mesh(_meshes("stage4")[1]):
        h2, _, _ = TM.forward(params, batch, cfg)
    assert torch.equal(h, h2)

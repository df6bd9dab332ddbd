"""Sharding inside a stage: the port's shard group against the reference's
GSPMD programs on the same meshes.

The reference runs once, in a module-scoped subprocess with 8 forced host
devices (XLA's device count is fixed at its first import): jitted
``loss_fn`` and ``jax.grad`` of it under ``jax.set_mesh`` of (2, 4),
(2, 2) and (1, 8) ``("data", "model")`` meshes, ``moe_fwd`` (its
``_moe_fwd_shardmap``) under (2, 4) and (1, 8), and each parameter's
``addressable_shards`` when placed by ``params_spec_tree``. Its params
come from ``jax.random.PRNGKey(0)`` and reach the port through
``params_from_jax``; every input is drawn here from a numpy seed and
handed to both. The port runs on meshes of ``["cpu"] * n``
(``launch.mesh.make_mesh(..., devices=...)``), each shard its own program
in one process.

Tolerances: the reference's own 2e-3 for a bf16 loss under a mesh
(``tests/test_sharding_dist.py``), ``GRAD_TOL`` 2e-4 for f32 losses and
gradients (``tests/test_kernel_grads.py:21``), per element with the same
relative part, and 2e-5 for the f32 MoE layer
(``test_moe_shardmap_matches_global``).
"""
import dataclasses
import json

import jax  # noqa: F401  (JAX beside torch, on the CPU)
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax, sharded_params_from_jax
from repro_torch.dist import sharding as TS
from repro_torch.dist import spmd
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import train_state as TTS
from repro_torch.train.pipeline_adapter import build_grad_step
from repro_torch.tree import flatten, tree_map
from tests.conftest import run_subprocess_devices

torch.set_num_threads(1)

GRAD_TOL = 2e-4
MESH_LOSS_TOL = 2e-3
MOE_TOL = 2e-5
B, S = 4, 32

# name -> (arch, mesh, config changes, f32)
LOSS_CASES = {
    "qwen-2x2": ("qwen2.5-32b", (2, 2), {}),
    "qwen-attn-tp-off-2x2": ("qwen2.5-32b", (2, 2), {"attn_tp": False}),
    "qwen-pad-heads-1x8": ("qwen2.5-32b", (1, 8), {"pad_heads": True}),
    "gemma2-pure-dp-2x4": ("gemma2-2b", (2, 4), {"pure_dp": True}),
    # Mamba's tensor parallelism: 8 heads on a model axis of 4 (each
    # shard K4 on 2 heads), and 4 heads of P 32 on 8, which do not divide
    # it (every model shard runs the whole mixer)
    "mamba-tp-2x4": ("mamba2-130m", (2, 4), {}),
    "mamba-heads-undivided-1x8": ("mamba2-130m", (1, 8), {"ssm_headdim": 32}),
    # ZeRO-3 weights (fsdp_params), gathered a period at a time
    "qwen110-fsdp-2x4": ("qwen1.5-110b", (2, 4), {}),
    "llama4-fsdp-2x4": ("llama4-scout-17b-a16e", (2, 4), {}),
    # Mamba TP, the MoE layer and ZeRO-3 together
    "jamba-2x4": ("jamba-1.5-large-398b", (2, 4), {}),
    # T5 on a model axis: the decoder-only stack at T5's widths (relu MLP,
    # untied head), as the reference lowers it there
    "t5-2x2": ("t5-paper", (2, 2), {}),
}
MOE_CASES = {
    "llama4-2x4": ("llama4-scout-17b-a16e", (2, 4), {"capacity_factor": 8.0}),
    "granite-1x8": ("granite-moe-3b-a800m", (1, 8), {}),
}
SHAPE_CASES = {"qwen-2x4": ("qwen2.5-32b", (2, 4)),
               "granite-1x8": ("granite-moe-3b-a800m", (1, 8)),
               "qwen110-fsdp-2x4": ("qwen1.5-110b", (2, 4)),
               "llama4-fsdp-2x4": ("llama4-scout-17b-a16e", (2, 4)),
               "jamba-fsdp-2x4": ("jamba-1.5-large-398b", (2, 4))}


def _batch_np(seed=0, vocab=512, b=B, s=S):
    """Two packed rows, one with a second segment and one padded tail."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    seg[1, 20:], pos[1, 20:] = 1, np.arange(s - 20)
    seg[2, 28:] = -1
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "loss_weights": (seg >= 0).astype(np.float32),
            "positions": pos, "segment_ids": seg}


def _moe_x(cfg, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)


_REF_CODE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
import repro
from jax.sharding import NamedSharding
from repro.configs.base import get_arch, reduced
from repro.dist.sharding import pure_dp
from repro.models import layers as L
from repro.models import model as MD
from repro.train import train_state as TS
out_dir = sys.argv[1] if len(sys.argv) > 1 else OUT_DIR
cases = json.loads(CASES)
batch = {k: jnp.asarray(v) for k, v in np.load(out_dir + "/batch.npz").items()}

def mesh_of(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + "/" + k)
    else:
        yield prefix, tree

def cfg_of(arch, changes, f32):
    cfg = dataclasses.replace(reduced(get_arch(arch)), **changes)
    return dataclasses.replace(cfg, dtype="float32") if f32 else cfg

save, res = {}, {}
# the reference's test: bf16 qwen, the loss under (2, 4) jitted
cfg = cfg_of("qwen2.5-32b", {}, False)
params = MD.init_params(jax.random.PRNGKey(0), cfg)
for k, v in flat(params):
    save["bf16" + k] = np.asarray(v.astype(jnp.float32))
with jax.set_mesh(mesh_of((2, 4))):
    res["bf16-loss-2x4"] = float(jax.jit(
        lambda p, b: MD.loss_fn(p, b, cfg)[0])(params, batch))
# bf16 t5-paper, the loss under (2, 2)
cfg = cfg_of("t5-paper", {}, False)
params = MD.init_params(jax.random.PRNGKey(0), cfg)
for k, v in flat(params):
    save["t5bf16" + k] = np.asarray(v.astype(jnp.float32))
with jax.set_mesh(mesh_of((2, 2))):
    res["t5-bf16-loss-2x2"] = float(jax.jit(
        lambda p, b: MD.loss_fn(p, b, cfg)[0])(params, batch))
for name, (arch, shape, changes) in cases["loss"].items():
    cfg = cfg_of(arch, changes, True)
    params = MD.init_params(jax.random.PRNGKey(0), cfg)
    for k, v in flat(params):
        save[name + k] = np.asarray(v)
    ctx = pure_dp(bool(changes.get("pure_dp")))
    with jax.set_mesh(mesh_of(shape)), ctx:
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, b: MD.loss_fn(p, b, cfg)[0]))(params, batch)
    res[name] = float(loss)
    for k, v in flat(g):
        save[name + "/grad" + k] = np.asarray(v)
for name, (arch, shape, changes) in cases["moe"].items():
    cfg = cfg_of(arch, changes, True)
    p = L.init_moe(jax.random.PRNGKey(0), cfg)
    for k, v in flat(p):
        save[name + k] = np.asarray(v)
    x = jnp.asarray(np.load(out_dir + "/moe_" + name + ".npy"))
    with jax.set_mesh(mesh_of(shape)):
        y, aux = jax.jit(lambda p, x: L.moe_fwd(p, x, cfg))(p, x)
    save[name + "/y"] = np.asarray(y)
    res[name + "/aux"] = float(aux)
for name, (arch, shape) in cases["shapes"].items():
    cfg = cfg_of(arch, {}, False)
    params = MD.init_params(jax.random.PRNGKey(0), cfg)
    mesh = mesh_of(shape)
    specs = TS.params_spec_tree(cfg, jax.eval_shape(lambda: params), mesh)
    order = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    shards = {}
    for (k, v), (_, sp) in zip(flat(params), flat(specs)):
        a = jax.device_put(v, NamedSharding(mesh, sp))
        shards[k] = sorted([order[s.device.id], list(s.data.shape),
                            [[sl.start or 0, n if sl.stop is None
                              else sl.stop]
                             for sl, n in zip(s.index, v.shape)]]
                           for s in a.addressable_shards)
    res[name + "/shards"] = shards
np.savez(out_dir + "/ref.npz", **save)
print("RESULT", json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd_ref")
    np.savez(d / "batch.npz", **_batch_np())
    for name, (arch, _, changes) in MOE_CASES.items():
        np.save(d / f"moe_{name}.npy", _moe_x(_cfg(arch, changes)))
    cases = {"loss": LOSS_CASES, "moe": MOE_CASES, "shapes": SHAPE_CASES}
    code = (f"OUT_DIR = {str(d)!r}\nCASES = {json.dumps(json.dumps(cases))}"
            f"\n" + _REF_CODE)
    out = run_subprocess_devices(code, n_devices=8, timeout=600)
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), dict(np.load(d / "ref.npz"))


def _cfg(arch, changes=None, f32=True):
    cfg = dataclasses.replace(reduced(get_arch(arch)), **(changes or {}))
    return dataclasses.replace(cfg, dtype="float32") if f32 else cfg


def _tree(arrays, prefix):
    """The nested dict of the arrays saved under ``prefix``, without the
    gradients and outputs saved beside them."""
    out: dict = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        parts = k[len(prefix) + 1:].split("/")
        if parts[0] in ("grad", "y"):
            continue
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * (shape[0] * shape[1]))


def _batch():
    return {k: torch.as_tensor(v) for k, v in _batch_np().items()}


def _close(got, want, tol):
    """Worst ``|got - want| / (tol + tol |want|)`` over the elements: at
    most 1 where every element is within tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (tol + tol * np.abs(want))))


def _grads_against(grads, arrays, prefix):
    """Worst :func:`_close` over the leaves of joined port gradients and
    the reference's under ``prefix/grad``."""
    ref = dict(flatten(_tree(arrays, prefix + "/grad")))
    got = dict(flatten(TTS.join_params(grads, "cpu")))
    assert sorted(got) == sorted(ref)
    return max(_close(got[k].float().numpy(), ref[k], GRAD_TOL) for k in ref)


def _port_value_and_grad(cfg, params, shape):
    mesh = _mesh(shape)
    with TS.set_mesh(mesh), TS.pure_dp(cfg.pure_dp):
        sp = TTS.shard_params(params, cfg, mesh)
        return spmd.value_and_grad(
            lambda p: TM.loss_fn(p, _batch(), cfg)[0], sp)


# ----------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------
def test_loss_under_a_data_model_mesh_matches_reference(ref):
    res, arrays = ref
    cfg = _cfg("qwen2.5-32b", f32=False)
    params = tree_map(lambda x: x.to(torch.bfloat16), params_from_jax(
        _tree(arrays, "bf16"), device="cpu"))
    with TS.set_mesh(_mesh((2, 4))):
        loss, _ = TM.loss_fn(params, _batch(), cfg)
    assert abs(float(loss) - res["bf16-loss-2x4"]) < MESH_LOSS_TOL

    # f32: the port under (2, 4) against its own mesh-free loss
    cfg32 = _cfg("qwen2.5-32b")
    p32 = tree_map(lambda x: x.float(), params)
    free, _ = TM.loss_fn(p32, _batch(), cfg32)
    with TS.set_mesh(_mesh((2, 4))):
        meshed, _ = TM.loss_fn(p32, _batch(), cfg32)
    assert abs(float(meshed) - float(free)) < GRAD_TOL


def test_t5_loss_in_a_group_matches_reference_in_bf16(ref):
    """T5 on a (2, 2) mesh in bf16 within the reference's 2e-3 of its
    GSPMD program; its f32 gradients are the ``t5-2x2`` case below."""
    res, arrays = ref
    cfg = _cfg("t5-paper", f32=False)
    params = tree_map(lambda x: x.to(torch.bfloat16), params_from_jax(
        _tree(arrays, "t5bf16"), device="cpu"))
    with TS.set_mesh(_mesh((2, 2))):
        loss, _ = TM.loss_fn(params, _batch(), cfg)
    assert abs(float(loss) - res["t5-bf16-loss-2x2"]) < MESH_LOSS_TOL


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_grads_match_jax_grad_under_the_same_mesh(ref, name):
    res, arrays = ref
    arch, shape, changes = LOSS_CASES[name]
    cfg = _cfg(arch, changes)
    params = params_from_jax(_tree(arrays, name), device="cpu")
    loss, grads = _port_value_and_grad(cfg, params, shape)
    assert _close(float(loss), res[name], GRAD_TOL) <= 1
    assert _grads_against(grads, arrays, name) <= 1


def test_a_planted_fault_fails_the_gradient_check(ref, monkeypatch):
    """A reduce that leaves out the last shard's addend must fail the
    same checks that pass above."""
    res, arrays = ref
    arch, shape, changes = LOSS_CASES["qwen-2x2"]
    cfg = _cfg(arch, changes)
    params = params_from_jax(_tree(arrays, "qwen-2x2"), device="cpu")
    real = spmd._sum
    monkeypatch.setattr(spmd, "_sum", lambda xs, dev: real(
        xs[:-1] if len(xs) > 1 else xs, dev))
    loss, grads = _port_value_and_grad(cfg, params, shape)
    assert (_close(float(loss), res["qwen-2x2"], GRAD_TOL) > 1
            or _grads_against(grads, arrays, "qwen-2x2") > 1)


class _NoGrad(torch.autograd.Function):
    """The identity whose backward gives zeros: a shard's K4 whose dB and
    dC never reach the sum."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def test_mamba_fault_without_one_shards_db_dc_fails(ref, monkeypatch):
    """Every shard's heads read the same B and C, so each shard's K4
    backward gives a partial dB and dC. Without the last model shard's
    partial the loss is unchanged, and the gradient of in_proj's B and C
    columns fails while the last layer's other columns pass."""
    from repro_torch.models import mamba as TMB
    res, arrays = ref
    name = "mamba-tp-2x4"
    arch, shape, changes = LOSS_CASES[name]
    cfg = _cfg(arch, changes)
    params = params_from_jax(_tree(arrays, name), device="cpu")
    real, calls = TMB.ops.ssd, []

    def ssd(x, dt, A, B, C, **kw):
        calls.append(1)
        if len(calls) % shape[1] == 0:           # the last model shard's
            B, C = _NoGrad.apply(B), _NoGrad.apply(C)
        return real(x, dt, A, B, C, **kw)
    monkeypatch.setattr(TMB.ops, "ssd", ssd)
    loss, grads = _port_value_and_grad(cfg, params, shape)
    assert _close(float(loss), res[name], GRAD_TOL) <= 1
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    got = TTS.join_params(grads, "cpu")["stack"]["l0"]["mixer"]["in_proj"]
    want = _tree(arrays, name + "/grad")["stack"]["l0"]["mixer"]["in_proj"]
    bc = slice(2 * di, 2 * di + 2 * gn)
    assert _close(got[..., bc].numpy(), want[..., bc], GRAD_TOL) > 1
    # the last layer's other columns, which no later layer's error
    # reaches, still agree
    others = np.r_[0:2 * di, 2 * di + 2 * gn:want.shape[-1]]
    assert _close(got[-1][..., others].numpy(), want[-1][..., others],
                  GRAD_TOL) <= 1


def test_fsdp_gathers_one_period_at_a_time(monkeypatch):
    """ZeRO-3 weights: each period's are gathered inside its checkpoint
    and dead before the next period's are gathered, in the forward and in
    the backward's recompute; no gather makes a whole stack leaf; each
    gradient leaf comes back in its own chunk's layout."""
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(_cfg("qwen1.5-110b"), n_layers=3)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    mesh = _mesh((2, 4))
    stack_shapes = {tuple(x.shape) for _, x in flatten(params["stack"])}
    real_pin, real_gather = TT._pin_fsdp, spmd._all_gather_raw
    pins, live_at_pin, gathered = [], [], []

    def pin(pparams, cfg_):
        live_at_pin.append(sum(r() is not None for r in pins))
        out = real_pin(pparams, cfg_)
        pins.extend(__import__("weakref").ref(x) for _, s in flatten(out)
                    for x in s.locals)
        return out

    def gather(xs, group, axes, dim):
        out = real_gather(xs, group, axes, dim)
        gathered.append(tuple(out[0].shape))
        return out
    monkeypatch.setattr(TT, "_pin_fsdp", pin)
    monkeypatch.setattr(spmd, "_all_gather_raw", gather)
    with TS.set_mesh(mesh):
        sp = TTS.shard_params(params, cfg, mesh)
        _, grads = spmd.value_and_grad(
            lambda p: TM.loss_fn(p, _batch(), cfg)[0], sp)
    # three periods forward, three recomputes
    assert len(live_at_pin) == 6 and live_at_pin == [0] * 6
    assert gathered and not stack_shapes & set(gathered)
    for (_, s), (_, gs) in zip(flatten(sp), flatten(grads)):
        assert gs.spec == s.spec
        assert [x.shape for x in gs.locals] == [x.shape for x in s.locals]


@pytest.mark.parametrize("name", ["mamba-tp-2x4", "gemma2-pure-dp-2x4"])
def test_the_recompute_runs_in_the_group_on_another_thread(name):
    """A CUDA backward runs in autograd's device thread, which has no
    ambient mesh, ``pure_dp`` flag or running group: the period
    checkpoint's recompute re-enters them. Here a backward on a thread of
    its own equals the backward on the forward's thread to the bit."""
    import threading
    arch, shape, changes = LOSS_CASES[name]
    cfg = _cfg(arch, changes)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    mesh = _mesh(shape)

    def forward():
        with TS.set_mesh(mesh), TS.pure_dp(cfg.pure_dp):
            sp = TTS.shard_params(params, cfg, mesh)
            leaves = [x.requires_grad_() for _, s in flatten(sp)
                      for x in s.locals]
            return TM.loss_fn(sp, _batch_for(cfg), cfg)[0], leaves

    loss, leaves = forward()
    same = torch.autograd.grad(loss, leaves, materialize_grads=True)
    loss, leaves = forward()
    out = {}
    worker = threading.Thread(target=lambda: out.setdefault(
        "g", torch.autograd.grad(loss, leaves, materialize_grads=True)))
    worker.start()
    worker.join()
    assert len(out["g"]) == len(same)
    assert all(torch.equal(a, b) for a, b in zip(out["g"], same))


def test_a_step_repeats_bit_for_bit():
    cfg = _cfg("qwen2.5-32b")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    step = build_grad_step(cfg)
    runs = []
    for _ in range(2):
        with TS.set_mesh(_mesh((2, 2))):
            ls, ws, g = step(params, _batch())
        runs.append((ls, ws, TTS.join_params(g, "cpu")))
    (l1, w1, g1), (l2, w2, g2) = runs
    assert torch.equal(l1, l2) and torch.equal(w1, w2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(g1), flatten(g2)))
    # and the step's sums equal the mesh-free step's within rounding
    l0, w0, _ = step(params, _batch())
    assert float(w0) == float(w1)
    assert abs(float(l0) - float(l1)) <= GRAD_TOL * abs(float(l0))


# ----------------------------------------------------------------------
# the MoE layer under a model axis
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_under_a_model_axis_matches_shardmap(ref, name):
    res, arrays = ref
    arch, shape, changes = MOE_CASES[name]
    cfg = _cfg(arch, changes)
    p = params_from_jax(_tree(arrays, name), device="cpu")
    x = torch.as_tensor(_moe_x(cfg))
    with TS.set_mesh(_mesh(shape)):
        y, aux = TL.moe_fwd(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), arrays[name + "/y"], atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(aux), res[name + "/aux"], rtol=MOE_TOL)
    if name == "granite-1x8":
        # expert-internal TP at the default capacity: the per-shard
        # dispatch drops tokens, so the mesh-free layer differs
        free, _ = TL.moe_fwd(p, x, cfg)
        assert cfg.n_experts % 8 and torch.isfinite(free).all()


# ----------------------------------------------------------------------
# layouts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SHAPE_CASES))
def test_shard_shapes_equal_addressable_shards(ref, name):
    res, _ = ref
    arch, shape = SHAPE_CASES[name]
    cfg = _cfg(arch, f32=False)
    mesh = _mesh(shape)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    sp = TTS.shard_params(params, cfg, mesh)
    want = res[name + "/shards"]
    for path, s in flatten(sp):
        key = "/" + "/".join(path)
        got = []
        for r, x in enumerate(s.locals):
            sl = spmd._chunk_slices(s.group, r, s.spec, s.shape)
            got.append([r, list(x.shape),
                        [[st, st + n] for _, st, n in sl]])
        assert sorted(got) == want[key], key
    joined = TTS.join_params(sp, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(joined), flatten(params)))


def test_sharded_params_from_jax_split_as_shard_params(ref):
    _, arrays = ref
    cfg = _cfg("qwen2.5-32b")
    mesh = _mesh((2, 4))
    tree = _tree(arrays, "qwen-2x2")
    a = sharded_params_from_jax(tree, cfg, mesh)
    b = TTS.shard_params(params_from_jax(tree, device="cpu"), cfg, mesh)
    for (pa, x), (pb, y) in zip(flatten(a), flatten(b)):
        assert pa == pb and x.spec == y.spec
        assert all(torch.equal(u, v) for u, v in zip(x.locals, y.locals))


# ----------------------------------------------------------------------
# collectives and meshes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["all_reduce", "all_gather",
                                  "reduce_scatter"])
def test_collectives_sum_in_rank_order_count_and_charge(kind):
    g = spmd.ShardGroup(_mesh((2, 4)))
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal((4, 8)).astype(np.float32),
                          dtype=torch.float32).requires_grad_()
          for _ in range(g.n)]
    spmd.reset_collective_counts()
    counter = op_cost.OpCounter()
    with counter:
        if kind == "all_reduce":
            out = spmd.all_reduce(xs, g, ("model",))
        elif kind == "all_gather":
            out = spmd.all_gather(xs, g, ("model",), 0)
        else:
            out = spmd.reduce_scatter(xs, g, ("model",), 0)
    counter.close()
    for members in g.groups(("model",)):
        whole = xs[members[0]].detach().clone()
        for m in members[1:]:
            whole = whole + xs[m].detach()
        for i, m in enumerate(members):
            if kind == "all_reduce":
                assert torch.equal(out[m], whole)
            elif kind == "all_gather":
                assert torch.equal(out[m], torch.cat(
                    [xs[j].detach() for j in members]))
            else:
                assert torch.equal(out[m], whole[i:i + 1])
    nbytes = out[0].numel() * 4
    assert spmd.collective_counts()[kind] == 1
    assert counter.summary.coll_counts == {kind.replace("_", "-"): 1}
    assert counter.summary.coll_link_bytes[kind.replace("_", "-")] == \
        op_cost.link_bytes(kind.replace("_", "-"), nbytes, 4)
    # the backward is the transpose: one more collective of the other kind
    torch.autograd.grad(sum(o.sum() for o in out), xs)
    assert sum(spmd.collective_counts().values()) == 2


def test_meshes_take_named_devices_and_never_fall_back():
    m = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4}
    assert [str(d) for d in m.devices.flat] == ["cpu"] * 8
    h = make_host_mesh(2, 2, devices=["cpu"] * 4)
    assert h.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="3 devices"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 4 devices"):
            make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="abstract"):
        spmd.ShardGroup(TS.Mesh(None, ("data", "model"), axis_sizes=(2, 2)))


def _batch_for(cfg):
    b = _batch()
    b["tokens"] = b["tokens"] % cfg.vocab
    return b


@pytest.mark.parametrize("what", ["t5-loss", "t5-prefill", "stage-mesh"])
def test_what_is_not_ported_raises_a23(what):
    """What raised naming ROADMAP A23 until the reference's extent of it
    was ported now runs: T5 in a shard group (its loss and its prefill,
    equal to the mesh-free ones within rounding), and a stage mesh with a
    further axis, each stage on the first device of its row."""
    mesh = _mesh((1, 2))
    if what.startswith("t5"):
        cfg = _cfg("t5-paper")
        params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        if what == "t5-loss":
            free = TM.loss_fn(params, _batch(), cfg)[0]
            with TS.set_mesh(mesh):
                got = TM.loss_fn(params, _batch(), cfg)[0]
            assert abs(float(got) - float(free)) <= GRAD_TOL
        else:
            batch = {k: v for k, v in _batch().items()
                     if k in ("tokens", "positions")}
            free, _ = TM.prefill(params, batch, cfg)
            with TS.set_mesh(mesh):
                got, _ = TM.prefill(params, batch, cfg)
            got = spmd.join(got)
            assert got.shape == free.shape
            assert _close(got.numpy(), free.numpy(), GRAD_TOL) <= 1
    else:
        from repro_torch.dist.pipeline import stage_devices
        devs = [f"cpu:{i}" for i in range(4)]
        two = make_mesh((2, 2), ("stage", "model"), devices=devs)
        assert [str(d) for d in stage_devices(two, 2)] == ["cpu:0", "cpu:2"]


def test_the_residual_between_blocks_is_split_by_sequence():
    """``shard(h, "dp", "sp", None)`` in a group: rows over data, the
    sequence over model; a sequence the axis does not divide stays
    whole."""
    g = spmd.ShardGroup(_mesh((2, 4)))
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    with spmd.running(g), TS.set_mesh(g.mesh):
        s = spmd.split(x, (), g)
        y = TS.shard(s, "dp", "sp", None)
        assert y.pspec == TS.P("data", "model")
        assert list(y.locals[5].shape) == [2, 2, 3]
        assert torch.equal(y.locals[5], x[2:4, 2:4])
        odd = spmd.split(x[:, :6], (), g)
        z = TS.shard(odd, "dp", "sp", None)
        assert z.pspec == TS.P("data") and z.locals[5].shape[1] == 6
        assert torch.equal(spmd.join(TS.shard(y, "dp", None, None)), x)
    # outside a group a tensor that would be split raises
    with TS.set_mesh(g.mesh), pytest.raises(NotImplementedError,
                                            match="shard group"):
        TS.shard(x, "dp", "sp", None)

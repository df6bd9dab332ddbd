"""Prefill and decode in a shard group: the port against the reference's
GSPMD programs on the same meshes.

The reference runs once, in a module-scoped subprocess with 8 forced host
devices: jitted ``prefill`` (a cache 16 positions longer than the prompt)
and then three jitted ``decode`` steps under ``jax.set_mesh`` of a
``("data", "model")`` mesh, for each case below; hubert-xlarge's loss and
``jax.grad`` of it (the frames input, which has no decode); and the
``addressable_shards`` of caches placed by the reference's resolution of
``transformer.cache_logical``. Its params come from
``jax.random.PRNGKey(0)`` in f32 and reach the port through
``params_from_jax``; every input is drawn here from a numpy seed and
handed to both. The port runs ``model.prefill`` and ``model.decode``
under meshes of ``["cpu"] * n`` (each shard its own program in one
process); its logits come back as a ``spmd.Sharded`` over the vocabulary
and its cache as a tree of them, joined here.

Held: every step's logits and every cache leaf after the last step,
within ``GRAD_TOL`` 2e-4 (f32, per element with the same relative part,
the tolerance of ``tests/test_torch_spmd.py``); the cache's spec tree
against the reference's shards; the merge of attention partials
(``spmd.merge_partials``) against the attention over every key, with a
slice that sees no key; and two runs equal to the bit.
"""
import dataclasses
import json

import jax  # noqa: F401  (JAX beside torch, on the CPU)
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.dist import sharding as TS
from repro_torch.dist import spmd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as KR
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.train import train_state as TTS
from repro_torch.tree import flatten
from tests.conftest import run_subprocess_devices

torch.set_num_threads(1)

GRAD_TOL = 2e-4
EXTRA, STEPS = 16, 3

# name -> (arch, mesh, config changes, rows, prompt length)
CASES = {
    # head-parallel, sequence-parallel and padded-head attention
    "qwen-2x2": ("qwen2.5-32b", (2, 2), {}, 4, 32),
    "qwen-attn-tp-off-2x2": ("qwen2.5-32b", (2, 2), {"attn_tp": False}, 4,
                             32),
    "qwen-pad-heads-1x8": ("qwen2.5-32b", (1, 8), {"pad_heads": True}, 4,
                           32),
    # a 32-token window and softcaps; at positions 64-66 the first model
    # shard's slice of the 80-position cache lies outside the window
    "gemma2-2x4": ("gemma2-2b", (2, 4), {}, 4, 64),
    # Mamba: 8 heads over 4 (K4 on 2 a shard), and 4 heads of P 32 over
    # 8, which do not divide it (the whole mixer on every shard, the ssm
    # cache whole, the conv cache split)
    "mamba-tp-2x4": ("mamba2-130m", (2, 4), {}, 4, 32),
    "mamba-heads-undivided-1x8": ("mamba2-130m", (1, 8),
                                  {"ssm_headdim": 32}, 4, 32),
    "granite-1x8": ("granite-moe-3b-a800m", (1, 8), {}, 4, 32),
    # one row, which the data axis does not divide
    "qwen-b1-2x4": ("qwen2.5-32b", (2, 4), {}, 1, 32),
    # the mixed input: 8 patches ahead of 24 tokens, decode the tokens
    "llava-2x4": ("llava-next-34b", (2, 4), {}, 4, 32),
    # Mamba, attention, MoE and ZeRO-3 weights together
    "jamba-2x4": ("jamba-1.5-large-398b", (2, 4), {}, 4, 32),
    # T5 on a model axis: the decoder-only stack at its widths, as the
    # reference serves it there
    "t5-2x2": ("t5-paper", (2, 2), {}, 4, 32),
}
# the frames input (encoder-only: its prefill, its loss and gradients)
HUBERT = ("hubert-xlarge", (2, 4), {}, 4, 32)
# cache layouts: name -> (arch, mesh, changes, rows, cache length)
CACHE_SHAPES = {
    "qwen-2x4": ("qwen2.5-32b", (2, 4), {}, 4, 48),
    "qwen-b1-2x4": ("qwen2.5-32b", (2, 4), {}, 1, 48),
    "qwen-odd-seq-2x4": ("qwen2.5-32b", (2, 4), {}, 4, 42),
    "mamba-1x8": ("mamba2-130m", (1, 8), {"ssm_headdim": 32}, 4, 48),
    "jamba-2x4": ("jamba-1.5-large-398b", (2, 4), {}, 2, 48),
}


def _cfg(arch, changes=None):
    cfg = dataclasses.replace(reduced(get_arch(arch)), **(changes or {}))
    return dataclasses.replace(cfg, dtype="float32")


def _inputs_np(name, seed=0):
    """The prompt batch and the decode steps' tokens of a case."""
    arch, _, changes, b, s = CASES[name] if name in CASES else HUBERT
    cfg = _cfg(arch, changes)
    rng = np.random.default_rng(seed)
    out = {"positions": np.tile(np.arange(s, dtype=np.int32), (b, 1)),
           "steps": rng.integers(0, cfg.vocab, (STEPS, b, 1)).astype(
               np.int32)}
    if cfg.input_mode == "frames":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
        out["mask"] = rng.random((b, s)) < 0.3
        out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        out["loss_weights"] = np.ones((b, s), np.float32)
        out["segment_ids"] = np.zeros((b, s), np.int32)
        return out
    p = cfg.n_patches if cfg.input_mode == "mixed" else 0
    out["tokens"] = rng.integers(0, cfg.vocab, (b, s - p)).astype(np.int32)
    if p:
        out["patches"] = rng.standard_normal((b, p, cfg.d_model)).astype(
            np.float32)
    return out


_REF_CODE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
import repro
from jax.sharding import NamedSharding
from repro.configs.base import get_arch, reduced
from repro.dist.sharding import spec_for
from repro.models import model as MD
from repro.models import transformer as T
out_dir = OUT_DIR
cases = json.loads(CASES)

def mesh_of(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + "/" + k)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flat(v, prefix + "/" + str(i))
    else:
        yield prefix, tree

def cfg_of(arch, changes):
    cfg = dataclasses.replace(reduced(get_arch(arch)), **changes)
    return dataclasses.replace(cfg, dtype="float32")

save, res = {}, {}
for name, (arch, shape, changes, b, s) in cases["serve"].items():
    cfg = cfg_of(arch, changes)
    params = MD.init_params(jax.random.PRNGKey(0), cfg)
    for k, v in flat(params):
        save[name + k] = np.asarray(v)
    inp = dict(np.load(out_dir + "/" + name + ".npz"))
    steps = inp.pop("steps")
    keep = ("tokens", "positions", "patches", "frames", "mask")
    batch = {k: jnp.asarray(v) for k, v in inp.items() if k in keep}
    with jax.set_mesh(mesh_of(shape)):
        logits, cache = jax.jit(lambda p, bt: MD.prefill(
            p, bt, cfg, cache_len=s + EXTRA))(params, batch)
        save[name + "/logits0"] = np.asarray(logits)
        if cfg.decode:
            step = jax.jit(lambda p, bt: MD.decode(p, bt, cfg))
            for i, tok in enumerate(steps):
                pos = jnp.full((b, 1), s + i, jnp.int32)
                logits, cache = step(params, {
                    "tokens": jnp.asarray(tok), "positions": pos,
                    "cache": cache, "cache_pos": jnp.int32(s + i)})
                save[name + "/logits%d" % (i + 1)] = np.asarray(logits)
            for k, v in flat(cache):
                save[name + "/cache" + k] = np.asarray(v)
    if not cfg.decode:
        batch = {k: jnp.asarray(v) for k, v in inp.items()}
        with jax.set_mesh(mesh_of(shape)):
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, bt: MD.loss_fn(p, bt, cfg)[0]))(params, batch)
        res[name + "/loss"] = float(loss)
        for k, v in flat(g):
            save[name + "/grad" + k] = np.asarray(v)
for name, (arch, shape, changes, b, s) in cases["caches"].items():
    cfg = cfg_of(arch, changes)
    mesh = mesh_of(shape)
    cache = T.init_cache(cfg, b, s, dtype=jnp.float32)
    order = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    shards = {}
    for i, (lc, lg) in enumerate(zip(cache, T.cache_logical(cfg))):
        for k in sorted(lc):
            v = lc[k]
            sp = spec_for(tuple(v.shape), tuple(lg[k]), mesh)
            a = jax.device_put(v, NamedSharding(mesh, sp))
            shards["/%d/%s" % (i, k)] = sorted(
                [order[x.device.id], list(x.data.shape),
                 [[sl.start or 0, n if sl.stop is None else sl.stop]
                  for sl, n in zip(x.index, v.shape)]]
                for x in a.addressable_shards)
    res[name + "/shards"] = shards
np.savez(out_dir + "/ref.npz", **save)
print("RESULT", json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd_serve_ref")
    serve = {**CASES, "hubert-2x4": HUBERT}
    for name in serve:
        np.savez(d / f"{name}.npz", **_inputs_np(name))
    cases = {"serve": serve, "caches": CACHE_SHAPES}
    code = (f"OUT_DIR = {str(d)!r}\nEXTRA = {EXTRA}\n"
            f"CASES = {json.dumps(json.dumps(cases))}\n" + _REF_CODE)
    out = run_subprocess_devices(code, n_devices=8, timeout=600)
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), dict(np.load(d / "ref.npz"))


def _tree(arrays, prefix):
    """The reference's params saved under ``prefix``, as a nested dict."""
    out: dict = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        parts = k[len(prefix) + 1:].split("/")
        if parts[0].startswith(("logits", "cache", "grad")):
            continue
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * (shape[0] * shape[1]))


def _close(got, want, tol=GRAD_TOL):
    """Worst ``|got - want| / (tol + tol |want|)``: at most 1 where every
    element is within tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (tol + tol * np.abs(want))))


def _serve(cfg, params, inp, mesh):
    """The port's prefill and decode steps under ``mesh`` (None: with no
    mesh): every step's logits and the cache, joined whole."""
    b, s = inp["positions"].shape
    keep = ("tokens", "positions", "patches", "frames", "mask")
    batch = {k: torch.as_tensor(v) for k, v in inp.items() if k in keep}
    with TS.set_mesh(mesh), torch.no_grad():
        logits, cache = TM.prefill(params, batch, cfg, cache_len=s + EXTRA)
        out = [logits]
        for i, tok in enumerate(inp["steps"] if cfg.decode else ()):
            pos = torch.full((b, 1), s + i, dtype=torch.int32)
            logits, cache = TM.decode(params, {
                "tokens": torch.as_tensor(tok), "positions": pos,
                "cache": cache, "cache_pos": s + i}, cfg)
            out.append(logits)
    if mesh is not None:
        out = [spmd.join(x, "cpu") for x in out]
        cache = None if cache is None else tuple(
            {k: spmd.join(v, "cpu") for k, v in lc.items()} for lc in cache)
    return out, cache


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_match_the_reference_under_the_same_mesh(ref,
                                                                     name):
    _, arrays = ref
    arch, shape, changes, _, _ = CASES[name]
    cfg = _cfg(arch, changes)
    params = params_from_jax(_tree(arrays, name), device="cpu")
    logits, cache = _serve(cfg, params, _inputs_np(name), _mesh(shape))
    assert len(logits) == STEPS + 1
    for i, x in enumerate(logits):
        assert _close(x.numpy(), arrays[f"{name}/logits{i}"]) <= 1, i
    got = dict(flatten({str(i): lc for i, lc in enumerate(cache)}))
    want = {k[len(name) + 7:]: v for k, v in arrays.items()
            if k.startswith(name + "/cache/")}
    assert sorted("/".join(k) for k in got) == sorted(want)
    for k, v in got.items():
        assert _close(v.numpy(), want["/".join(k)]) <= 1, k


def test_frames_prefill_loss_and_grads_match_the_reference(ref):
    """hubert-xlarge on (2, 4): the frame adapter column-parallel, the
    mask embedding on the masked frames; its encode (prefill, no cache),
    its loss and every gradient leaf."""
    res, arrays = ref
    arch, shape, changes, _, _ = HUBERT
    cfg = _cfg(arch, changes)
    params = params_from_jax(_tree(arrays, "hubert-2x4"), device="cpu")
    inp = _inputs_np("hubert-2x4")
    logits, cache = _serve(cfg, params, inp, _mesh(shape))
    assert cache is None and len(logits) == 1
    assert _close(logits[0].numpy(), arrays["hubert-2x4/logits0"]) <= 1
    batch = {k: torch.as_tensor(v) for k, v in inp.items() if k != "steps"}
    mesh = _mesh(shape)
    with TS.set_mesh(mesh):
        loss, grads = spmd.value_and_grad(
            lambda p: TM.loss_fn(p, batch, cfg)[0],
            TTS.shard_params(params, cfg, mesh))
    assert _close(float(loss), res["hubert-2x4/loss"]) <= 1
    got = dict(flatten(TTS.join_params(grads, "cpu")))
    pre = "hubert-2x4/grad/"
    want = {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}
    assert sorted("/".join(k) for k in got) == sorted(want)
    assert max(_close(v.numpy(), want["/".join(k)])
               for k, v in got.items()) <= 1


@pytest.mark.parametrize("name", list(CACHE_SHAPES))
def test_cache_spec_tree_equals_addressable_shards(ref, name):
    """The cache a shard group makes (``transformer.init_cache`` inside a
    running group) has the reference's shards: KV rows over data and the
    sequence over model (whole where 42 positions do not divide 8, and
    rows whole where one row does not divide 2); Mamba's conv channels
    split while its 4 heads, which do not divide 8, stay whole."""
    res, _ = ref
    arch, shape, changes, b, s = CACHE_SHAPES[name]
    cfg = _cfg(arch, changes)
    mesh = _mesh(shape)
    g = spmd.ShardGroup(mesh)
    with spmd.running(g), TS.set_mesh(mesh):
        cache = TT.init_cache(cfg, b, s, dtype=torch.float32)
    whole = TT.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    specs = TTS.cache_spec_tree(cfg, whole, mesh)
    want = res[name + "/shards"]
    for i, lc in enumerate(cache):
        for k, v in lc.items():
            assert v.pspec == specs[i][k]
            got = []
            for r, x in enumerate(v.locals):
                sl = spmd._chunk_slices(g, r, v.spec, v.shape)
                got.append([r, list(x.shape),
                            [[st, st + n] for _, st, n in sl]])
            assert sorted(got) == want[f"/{i}/{k}"], (i, k)
            assert not any(bool(x.any()) for x in v.locals)


# ----------------------------------------------------------------------
# the merge of attention partials
# ----------------------------------------------------------------------
def _qkv(b=2, t=3, h=4, kv=2, s=40, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, h, d, generator=g),
            torch.randn(b, s, kv, d, generator=g),
            torch.randn(b, s, kv, d, generator=g))


def test_merge_of_slices_equals_the_attention_over_every_key():
    """Four slices of 10 keys each, every query at position 38 to 40 and
    a 12-key window: slices 0 and 1 see no key. Their merged partials
    equal the attention over all 40 keys, the dead slices add nothing to
    the bit, and a merge of dead slices alone is zero with no NaN."""
    q, k, v = _qkv()
    b, t, _, _ = q.shape
    s = k.shape[1]
    qpos = torch.arange(s - t, s, dtype=torch.int32)[None].expand(b, t)
    kpos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    opts = dict(causal=True, window=12, softcap=30.0)
    want_o, want_l = KR.attention_ref_with_lse(
        q, k, v, q_positions=qpos, kv_positions=kpos, **opts)
    parts = [ops.attention_partial(q, k[:, i:i + 10], v[:, i:i + 10],
                                   q_positions=qpos,
                                   kv_positions=kpos[:, i:i + 10], **opts)
             for i in range(0, s, 10)]
    assert all(float(p[1].max()) < -1e29 for p in parts[:2])
    assert not any(bool(p[0].any()) for p in parts[:2])
    o, lse = spmd.merge_partials([p[0] for p in parts],
                                 [p[1] for p in parts])
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_l, atol=1e-5, rtol=1e-5)
    live_o, live_l = spmd.merge_partials([p[0] for p in parts[2:]],
                                         [p[1] for p in parts[2:]])
    assert torch.equal(live_o, o) and torch.equal(live_l, lse)
    dead_o, dead_l = spmd.merge_partials([p[0] for p in parts[:2]],
                                         [p[1] for p in parts[:2]])
    assert not bool(dead_o.any()) and bool(torch.isfinite(dead_l).all())
    # without the last slice's partial the merge is wrong
    bad, _ = spmd.merge_partials([p[0] for p in parts[:-1]],
                                 [p[1] for p in parts[:-1]])
    assert float((bad - want_o).abs().max()) > 1e-2


def test_merge_attention_is_a_counted_collective():
    """Over the model axis of a (2, 4) group: every member gets its
    group's merge, summed in ascending rank; one collective counted,
    charged as an all-reduce of o and lse; on meta, shapes only."""
    from repro_torch.launch import op_cost
    g = spmd.ShardGroup(_mesh((2, 4)))
    q, k, v = _qkv(s=32)
    b, t = q.shape[:2]
    qpos = torch.full((b, t), 31, dtype=torch.int32)
    parts = [ops.attention_partial(
        q, k[:, 8 * i:8 * i + 8], v[:, 8 * i:8 * i + 8], q_positions=qpos,
        kv_positions=torch.arange(8 * i, 8 * i + 8)[None].expand(b, 8))
        for i in range(4)]
    os_ = [parts[g.coord(r, "model")][0] for r in range(g.n)]
    ls_ = [parts[g.coord(r, "model")][1] for r in range(g.n)]
    spmd.reset_collective_counts()
    counter = op_cost.OpCounter()
    with counter:
        o, lse = spmd.merge_attention(os_, ls_, g, ("model",))
    counter.close()
    want, _ = spmd.merge_partials([p[0] for p in parts],
                                  [p[1] for p in parts])
    assert all(torch.equal(x, want) for x in o)
    assert spmd.collective_counts()["attention_merge"] == 1
    out_bytes = o[0].numel() * 4 + lse[0].numel() * 4
    assert counter.summary.coll_link_bytes == {
        "attention-merge": op_cost.link_bytes("all-reduce", out_bytes, 4)}
    meta = spmd.ShardGroup(make_mesh((2, 4), ("data", "model"),
                                     devices=["meta"] * 8))
    mo, ml = spmd.merge_attention([x.to("meta") for x in os_],
                                  [x.to("meta") for x in ls_], meta,
                                  ("model",))
    assert mo[0].device.type == "meta" and mo[0].shape == o[0].shape


def test_two_sharded_serves_are_equal_to_the_bit():
    """gemma2 on (2, 4), prefill and three decode steps twice: every
    logit and cache element equal; and equal to the serve with no mesh
    within rounding."""
    name = "gemma2-2x4"
    arch, shape, changes, _, _ = CASES[name]
    cfg = _cfg(arch, changes)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    inp = _inputs_np(name)
    runs = [_serve(cfg, params, inp, _mesh(shape)) for _ in range(2)]
    (l1, c1), (l2, c2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten({str(i): x for i, x in enumerate(c1)}),
        flatten({str(i): x for i, x in enumerate(c2)})))
    free, _ = _serve(cfg, params, inp, None)
    assert max(_close(a.numpy(), b.numpy()) for a, b in zip(l1, free)) <= 1


def test_a_planted_merge_fault_fails_the_logits_check(ref, monkeypatch):
    """The merge without the last model shard's partial must fail the
    check that passes above."""
    _, arrays = ref
    name = "qwen-2x2"
    arch, shape, changes, _, _ = CASES[name]
    cfg = _cfg(arch, changes)
    params = params_from_jax(_tree(arrays, name), device="cpu")
    real = spmd.merge_partials
    monkeypatch.setattr(spmd, "merge_partials",
                        lambda os_, ls_: real(os_[:-1], ls_[:-1]))
    logits, _ = _serve(cfg, params, _inputs_np(name), _mesh(shape))
    assert _close(logits[0].numpy(), arrays[f"{name}/logits0"]) <= 1
    assert max(_close(x.numpy(), arrays[f"{name}/logits{i}"])
               for i, x in enumerate(logits)) > 1

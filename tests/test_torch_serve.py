"""The port's serving path against the JAX reference, end to end.

Weights come from ``repro.models.model.init_params(PRNGKey(0), cfg)`` and
cross over through ``params_from_jax``. Tolerances: 1e-4 in f32, where only
the summation order differs over two layers. In bf16, 2e-2 (the reference's
bf16 kernel tolerance) on the largest difference divided by 1 + the largest
|value| of the reference: bf16 keeps 8 significant bits and the two
frameworks round at different points (GELU, matmul outputs, residual adds),
so each is a few ulps of the largest logits away from an f32 forward, in
either direction.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.microbatch import dp_split, order_samples
from repro.core.shapes import ShapePalette
from repro.data.synthetic import MultiTaskDataset
from repro.models import model as JM
from repro_torch import serve as SV
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype):
    j = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")), n_layers=2,
                            dtype=dtype)
    t = dataclasses.replace(SV.make_config("gpt-paper", "reduced", 2),
                            dtype=dtype)
    return j, t


def _example():
    """examples/serve_batched.py as a module (its main() is not run)."""
    path = Path(__file__).resolve().parents[1] / "examples" / "serve_batched.py"
    spec = importlib.util.spec_from_file_location("serve_batched_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, tol, what):
    out, ref = out.float().numpy(), _np(ref)
    if tol == TOL["float32"]:
        np.testing.assert_allclose(out, ref, atol=tol, rtol=tol, err_msg=what)
    else:
        err = np.abs(out - ref).max() / (1.0 + np.abs(ref).max())
        assert err <= tol, f"{what}: scaled error {err:.3e} > {tol}"


def test_params_from_jax_keeps_tree_shapes_dtypes_and_bits():
    jcfg, _ = _cfgs("bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jl) == 11     # embed, head, final_norm, 8 stacked block leaves
    for path, leaf in jl:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))
    assert tp["stack"]["l0"]["mixer"]["wq"].shape == (2, 64, 64)


def test_init_params_matches_reference_shapes_and_scales():
    jcfg, tcfg = _cfgs("float32")
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert t.dtype == torch.float32
        # same distribution: the std agrees within sampling error
        np.testing.assert_allclose(float(t.std()), float(leaf.std()),
                                   rtol=0.1, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(0)
    b, s, steps = 3, 24, 4
    tok = r.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[2, 17:], tok[2, 17:] = 0, 0          # a shorter prompt, padded
    jlog, jc = JM.prefill(jp, {"tokens": jnp.asarray(tok),
                               "positions": jnp.asarray(pos)}, jcfg,
                          impl="ref", cache_len=s + steps)
    with torch.inference_mode():
        tlog, tc = TM.prefill(tp, {"tokens": torch.from_numpy(tok),
                                   "positions": torch.from_numpy(pos)}, tcfg,
                              cache_len=s + steps)
    assert tlog.dtype == torch.float32 and tlog.shape == (b, 512)
    _close(tlog, jlog, TOL[dtype], "prefill logits")
    for name in ("k", "v"):
        _close(tc[0][name], jc[0][name], TOL[dtype], f"prefill cache {name}")
    nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    for step in range(steps):
        p = np.full((b, 1), s + step, np.int32)
        jlog, jc = JM.decode(jp, {"tokens": jnp.asarray(nxt),
                                  "positions": jnp.asarray(p), "cache": jc,
                                  "cache_pos": jnp.asarray(s + step,
                                                           jnp.int32)},
                             jcfg, impl="ref")
        with torch.inference_mode():
            tlog, tc = TM.decode(tp, {"tokens": torch.from_numpy(nxt),
                                      "positions": torch.from_numpy(p),
                                      "cache": tc, "cache_pos": s + step},
                                 tcfg)
        _close(tlog, jlog, TOL[dtype], f"decode step {step} logits")
        for name in ("k", "v"):
            _close(tc[0][name], jc[0][name], TOL[dtype],
                   f"decode step {step} cache {name}")
        # both continue from the reference's greedy token
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)


def _reference_serve(ex, jcfg, tokens, max_prompt, steps):
    """examples/serve_batched.py's loop on the reference, returning the
    batches and per batch the logits and greedy tokens of every step."""
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    lens = np.array([len(t) for t in tokens])
    pal = ShapePalette.build(min_seq=32, max_seq=max_prompt, seq_align=32,
                             max_mbs=16)
    order = order_samples(lens)
    batches = dp_split(lens[order], ex.PrefillCost(jcfg, n_stages=1), 1,
                       palette=pal, mem_limit=1e12)
    prefill_j = jax.jit(lambda p, b: JM.prefill(
        p, b, jcfg, cache_len=b["positions"].shape[1] + steps))
    decode_j = jax.jit(lambda p, b: JM.decode(p, b, jcfg))
    out = []
    for mb in batches:
        b, s = mb.mbs, mb.seq
        tok = np.zeros((b, s), np.int32)
        pos = np.zeros((b, s), np.int32)
        for row, idx in enumerate(mb.indices):
            t = tokens[order[idx]][:s]
            tok[row, : len(t)] = t
            pos[row, : len(t)] = np.arange(len(t))
        logits, cache = prefill_j(jp, {"tokens": jnp.asarray(tok),
                                       "positions": jnp.asarray(pos)})
        nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        all_logits, all_tok = [logits], [nxt]
        for step in range(steps):
            db = {"tokens": nxt,
                  "positions": jnp.full((b, 1), s + step, jnp.int32),
                  "cache": cache, "cache_pos": jnp.asarray(s + step, jnp.int32)}
            logits, cache = decode_j(jp, db)
            nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            all_logits.append(logits)
            all_tok.append(nxt)
        out.append((np.stack([np.asarray(x) for x in all_logits]),
                    np.concatenate([np.asarray(x) for x in all_tok], 1)))
    return jp, order, batches, out


def test_serve_loop_at_defaults_matches_reference_example():
    ex = _example()
    assert (SV.MAX_PROMPT, SV.DECODE_STEPS, SV.N_REQUESTS) == \
        (ex.MAX_PROMPT, ex.DECODE_STEPS, ex.N_REQUESTS)
    jcfg, _ = _cfgs("bfloat16")
    tcfg = SV.make_config("gpt-paper", "reduced", 2)
    assert tcfg.dtype == "bfloat16" and jcfg.dtype == "bfloat16"
    tokens = SV.make_requests(tcfg, SV.N_REQUESTS, SV.MAX_PROMPT)
    _, jtokens, _ = MultiTaskDataset(n_tasks=16, max_len=SV.MAX_PROMPT,
                                     seed=3).sample_minibatch(SV.N_REQUESTS,
                                                              jcfg.vocab)
    for a, b in zip(tokens, jtokens):
        np.testing.assert_array_equal(a, b)
    jp, jorder, jbatches, jout = _reference_serve(
        ex, jcfg, jtokens, SV.MAX_PROMPT, SV.DECODE_STEPS)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    res = SV.serve(tp, tcfg, tokens)
    np.testing.assert_array_equal(res.order, jorder)
    assert [dataclasses.astuple(m) for m in res.batches] == \
        [dataclasses.astuple(m) for m in jbatches]
    tol, compared = TOL["bfloat16"], 0
    assert (res.prompt_tokens, res.decode_tokens) == (
        sum(len(t) for t in tokens), SV.N_REQUESTS * SV.DECODE_STEPS)
    for (jlog, jtok), tlog, ttok in zip(jout, res.logits, res.tokens):
        assert ttok.shape == jtok.shape == (jlog.shape[1], SV.DECODE_STEPS + 1)
        tlog = tlog.numpy()
        for row in range(jtok.shape[0]):
            # step 0 is the prefill, the pad-row quirk included
            for step in range(jtok.shape[1]):
                ref, out = jlog[step, row], tlog[step, row]
                eps = np.abs(out - ref).max()
                assert eps <= tol * (1 + np.abs(ref).max()), (row, step, eps)
                compared += 1
                if ttok[row, step] != jtok[row, step]:
                    # greedy tokens may differ only where the logits' own
                    # difference can flip the top two; the rows then diverge
                    top2 = np.sort(ref)[-2:]
                    assert top2[1] - top2[0] <= 2 * eps, (row, step)
                    break
    # most rows stay in lockstep through every step (205 of 216 here)
    assert compared >= 0.9 * sum(j[1].size for j in jout)

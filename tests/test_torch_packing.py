"""The port's packing baseline (``core/packing.py``) against the
reference's, and a training step on packed rows.

``core/packing.py`` is a verbatim copy (``tests/test_torch_planning.py``'s
``COPIED``). Here each of its functions runs in both packages on the
lengths of three seeds of a small stream (decoder-only lengths, and the
(enc, dec) pairs of an encoder-decoder stream) and must give the same
output: the packed rows, the micro-batches and their costs, the packing
efficiency. Then the paper's MLM+DS baseline as ``benchmarks/bench_e2e.py``
trains on it: rows from ``pack_first_fit`` through
``materialize_packed_rows`` into the reduced gpt-paper's
``build_grad_step``, and (enc, dec) rows from ``pack_encdec_first_fit``
through ``materialize_packed_encdec_rows`` into the reduced t5-paper's
``build_encdec_grad_step``, in f32, against the reference's steps (its
``impl="ref"`` attention) on the same weights, within ``GRAD_TOL`` 2e-4
(``tests/test_kernel_grads.py:21``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core import packing as JP
from repro.core.cost_model import AnalyticCostModel as JCost
from repro.models import model as JM
from repro.models import transformer as JT
from repro.train.pipeline_adapter import build_encdec_grad_step as j_encdec
from repro.train.pipeline_adapter import build_grad_step as j_grad
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import packing as TP
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.data.dataset import (materialize_packed_encdec_rows,
                                      materialize_packed_rows)
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.train.pipeline_adapter import (build_encdec_grad_step,
                                                build_grad_step)
from repro_torch.tree import flatten

torch.set_num_threads(1)

GRAD_TOL = 2e-4
SEEDS = (0, 1, 2)
MAX_LEN, MAX_ENC, MAX_DEC, ROWS_PER_MB = 256, 256, 64, 4


def _lengths(seed, encdec=False):
    """A global batch's lengths: (n,) tokens, or (n, 2) (enc, dec)."""
    gb = MultiTaskStream(StreamConfig(
        n_tasks=8, global_tokens=2048, max_len=MAX_LEN, vocab=512,
        encdec_fraction=1.0 if encdec else 0.0, seed=seed)).batch(0)
    return gb.lengths if encdec else gb.lengths[:, 0]


def _costs():
    return (JCost(j_reduced(j_get_arch("gpt-paper"))),
            AnalyticCostModel(reduced(get_arch("gpt-paper"))))


def _rows(rows):
    return [(r.sample_indices, r.used, r.capacity) for r in rows]


def _mbs(mbs):
    return [dataclasses.astuple(m) for m in mbs]


def _run(pkg, cost, name, seed):
    """One packing function of ``pkg`` on the seed's lengths, its output
    as plain values."""
    lens, pairs = _lengths(seed), _lengths(seed, encdec=True)
    if name == "pack_first_fit":
        return _rows(pkg.pack_first_fit(lens, MAX_LEN // 2))
    if name == "pack_encdec_first_fit":
        return pkg.pack_encdec_first_fit(pairs, MAX_ENC, MAX_DEC)
    if name == "packing_micro_batches":
        return _mbs(pkg.packing_micro_batches(lens, MAX_LEN, ROWS_PER_MB,
                                              cost))
    if name == "packing_efficiency":
        return pkg.packing_efficiency(pkg.pack_first_fit(lens, MAX_LEN))
    if name == "token_based_micro_batches":
        return (_mbs(pkg.token_based_micro_batches(lens, 512, cost))
                + _mbs(pkg.token_based_micro_batches(pairs, 512, cost)))
    return (_mbs(pkg.fixed_size_micro_batches(lens, 3, cost))
            + _mbs(pkg.fixed_size_micro_batches(pairs, 3, cost)))


FUNCTIONS = ["pack_first_fit", "pack_encdec_first_fit",
             "packing_micro_batches", "packing_efficiency",
             "token_based_micro_batches", "fixed_size_micro_batches"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", FUNCTIONS)
def test_packing_functions_equal_the_reference(name, seed):
    jcost, tcost = _costs()
    got = _run(TP, tcost, name, seed)
    assert got and got == _run(JP, jcost, name, seed)


def test_the_streams_pack_several_samples_a_row():
    """The streams above do pack: rows of several samples, every sample
    placed once, the rows' fill within their capacity and their
    efficiency the clipped lengths over the rows' capacity."""
    for seed in SEEDS:
        lens = _lengths(seed)
        rows = TP.pack_first_fit(lens, MAX_LEN)
        placed = sorted(i for r in rows for i in r.sample_indices)
        assert placed == list(range(len(lens)))
        assert max(len(r.sample_indices) for r in rows) > 1
        assert all(r.used <= r.capacity for r in rows)
        assert TP.packing_efficiency(rows) == sum(
            min(int(n), MAX_LEN) for n in lens) / (MAX_LEN * len(rows))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(got, want):
    want = dict(flatten(_np(want)))
    got = dict(flatten(got))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.float().numpy(), want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(k))


def test_grad_step_on_packed_rows_matches_reference():
    """gpt-paper, reduced, f32: the four packed rows of 256 that hold the
    most samples (segments restart the positions), padding after."""
    jcfg = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch("gpt-paper")),
                               dtype="float32")
    gb = MultiTaskStream(StreamConfig(n_tasks=8, global_tokens=2048,
                                      max_len=MAX_LEN, vocab=tcfg.vocab,
                                      seed=4)).batch(0)
    rows = sorted(TP.pack_first_fit(gb.lengths, MAX_LEN),
                  key=lambda r: len(r.sample_indices),
                  reverse=True)[:ROWS_PER_MB]
    assert len(rows[0].sample_indices) > 1
    batch = materialize_packed_rows(rows, gb.tokens, MAX_LEN)
    jparams = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    jl, jw, jg = j_grad(jcfg, impl="ref")(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tw, tg = build_grad_step(tcfg)(
        params_from_jax(_np(jparams), device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    assert float(tw) == float(jw) == float(batch["loss_weights"].sum())
    _close_trees(tg, jg)


def test_encdec_grad_step_on_packed_rows_matches_reference():
    """t5-paper, reduced, f32: the four (enc, dec) rows of (256, 64) from
    ``pack_encdec_first_fit`` that hold the most samples, decoder segment
    s attending only encoder segment s."""
    jcfg = dataclasses.replace(j_reduced(j_get_arch("t5-paper")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch("t5-paper")),
                               dtype="float32")
    gb = MultiTaskStream(StreamConfig(n_tasks=8, global_tokens=2048,
                                      max_len=MAX_LEN, vocab=tcfg.vocab,
                                      encdec_fraction=1.0, seed=4)).batch(0)
    rows = TP.pack_encdec_first_fit(gb.lengths, MAX_ENC, MAX_DEC)
    rows = sorted(rows, key=len, reverse=True)[:ROWS_PER_MB]
    assert len(rows[0]) > 1
    batch = materialize_packed_encdec_rows(rows, gb.tokens, gb.lengths,
                                           MAX_ENC, MAX_DEC)
    jparams = jax.jit(JT.init_encdec, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    jl, jw, jg = j_encdec(jcfg, impl="ref")(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tw, tg = build_encdec_grad_step(tcfg)(
        params_from_jax(_np(jparams), device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    assert float(tw) == float(jw) == float(batch["loss_weights"].sum())
    _close_trees(tg, jg)

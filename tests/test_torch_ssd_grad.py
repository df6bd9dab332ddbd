"""K4's backward in plain PyTorch, and Mamba2 training, against the reference.

``ref.ssd_chunked_bwd`` is the reverse walk over 64-step chunks that the
CUDA backward (``csrc/ssd_bwd.cu``) takes. Here, on the CPU, at small
sizes (T <= 256, H <= 4, P and N <= 16), with inputs made by numpy from a
seed:

- it equals autograd of the port's ``ref.ssd_ref_chunked`` in f32, to
  ``PLAIN_TOL`` (relative, by norm): only the order of fp32 sums differs.
  Cases: T not a multiple of 64, G < H, a nonzero gradient of the final
  state, and strong decay where the -60 clips bite. In that case the walk
  takes the oracle's own 128-step chunks: at 64 steps the clips bite at
  other pairs, and dA, a sum of terms that cancel, moves by about 0.3%;
- it equals ``jax.grad`` of the reference's oracles at the reference's
  f32 ``GRAD_TOL`` (tests/test_kernel_grads.py:21): ``ssd_ref_chunked``,
  and ``ssd_ref`` from an initial state for ``d_initial`` (ROADMAP A17);
- ``ref.ssd_chunked_bwd_parallel``, the two passes the CUDA backward
  takes (the walk that carries only dS', then every chunk at once), equals
  the walk to ``PLAIN_TOL`` and ``jax.grad`` of the reference's oracles to
  ``GRAD_TOL``: G 1 and 2, T not a multiple of 64, with and without
  ``d_final`` and an initial state, and jamba's head and state (P 128, N
  128);
- the port's sequential runner trains reduced mamba2-130m for 2
  iterations with the reference runner's losses and gradient norms on the
  same plans (rtol 2e-4, as ``tests/test_torch_train.py`` holds gpt-paper).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.core.cost_model import AnalyticCostModel as JCost
from repro.core.planner import PlannerConfig as JPlannerConfig
from repro.core.shapes import ShapePalette as JPalette
from repro.data.streams import MultiTaskStream as JStream
from repro.data.streams import StreamConfig as JStreamConfig
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.train.runner import PlanAheadRunner as JRunner
from repro.train.runner import RunnerConfig as JRunnerConfig
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.shapes import ShapePalette
from repro_torch.data.streams import MultiTaskStream, StreamConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.train.runner import PlanAheadRunner, RunnerConfig

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

PLAIN_TOL = 5e-5
GRAD_TOL = 2e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_initial")


def _inputs(b, t, h, p, g, n, seed=0, a_scale=1.0):
    """x, dt, A, B, C, dy, d_final and an initial state, as numpy f32."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, t, h)))).astype(np.float32)
    A = (-np.exp(r.standard_normal(h)) * a_scale).astype(np.float32)
    B = r.standard_normal((b, t, g, n)).astype(np.float32)
    C = r.standard_normal((b, t, g, n)).astype(np.float32)
    dy = r.standard_normal((b, t, h, p)).astype(np.float32)
    d_final = r.standard_normal((b, h, p, n)).astype(np.float32)
    s0 = r.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, dy, d_final, s0


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def _plain_bwd(arrays, use_final, use_init, chunk=64):
    x, dt, A, B, C, dy, d_final, s0 = (torch.from_numpy(v) for v in arrays)
    init = s0 if use_init else None
    starts = tref.ssd_chunk_parallel(x, dt, A, B, C, chunk,
                                     initial_state=init)[2]
    return tref.ssd_chunked_bwd(x, dt, A, B, C, dy, starts,
                                d_final=d_final if use_final else None,
                                initial_state=init, chunk=chunk)


@pytest.mark.parametrize("b,t,h,p,g,n,a_scale,use_final,chunk", [
    (2, 150, 4, 8, 2, 8, 1.0, False, 64),     # ragged T, G < H
    (2, 192, 4, 16, 1, 16, 1.0, True, 64),    # d_final, one group
    (1, 200, 2, 8, 1, 8, 40.0, True, 128),    # strong decay: clips bite
])
def test_plain_backward_matches_autograd_of_the_chunked_plain_version(
        b, t, h, p, g, n, a_scale, use_final, chunk):
    arrays = _inputs(b, t, h, p, g, n, a_scale=a_scale)
    if a_scale > 1:   # the clips bite: some in-chunk decay passes -60
        a = arrays[1] * arrays[2]
        assert (np.cumsum(a[:, :64], 1) < -60).any()
    x, dt, A, B, C, dy, d_final, _ = (torch.from_numpy(v) for v in arrays)
    ins = [v.clone().requires_grad_() for v in (x, dt, A, B, C)]
    y, st = tref.ssd_ref_chunked(*ins)
    loss = (y * dy).sum() + ((st * d_final).sum() if use_final else 0.0)
    want = torch.autograd.grad(loss, ins)
    got = _plain_bwd(arrays, use_final, False, chunk)
    assert got[0].shape == x.shape and got[3].shape == B.shape
    assert got[5].shape == (b, h, p, n)
    for name, o, w in zip(NAMES, got, want):
        assert _rel(o, w) <= PLAIN_TOL, (name, _rel(o, w))


def test_plain_backward_matches_jax_grad_of_the_reference_oracles():
    # ssd_ref_chunked (T a multiple of its 128-step chunk), G < H, d_final
    arrays = _inputs(2, 256, 4, 8, 2, 8, seed=1)
    x, dt, A, B, C, dy, d_final, s0 = (jnp.asarray(v) for v in arrays)

    def j_loss(x, dt, A, B, C):
        y, st = jref.ssd_ref_chunked(x, dt, A, B, C, return_state=True)
        return jnp.sum(y * dy) + jnp.sum(st * d_final)
    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(x, dt, A, B, C)
    got = _plain_bwd(arrays, True, False)
    for name, o, w in zip(NAMES, got, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)

    # ssd_ref from an initial state, ragged T: d_initial too (A17)
    arrays = _inputs(2, 100, 4, 8, 2, 8, seed=2)
    x, dt, A, B, C, dy, d_final, s0 = (jnp.asarray(v) for v in arrays)

    def j_loss0(x, dt, A, B, C, s0):
        y, st = jref.ssd_ref(x, dt, A, B, C, initial_state=s0,
                             return_state=True)
        return jnp.sum(y * dy) + jnp.sum(st * d_final)
    want = jax.grad(j_loss0, argnums=(0, 1, 2, 3, 4, 5))(x, dt, A, B, C, s0)
    got = _plain_bwd(arrays, True, True)
    for name, o, w in zip(NAMES, got, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    # and the port's CPU path from an initial state is the reference's
    tx, tdt, tA, tB, tC, _, _, ts0 = (torch.from_numpy(v) for v in arrays)
    y, st = ops.ssd(tx, tdt, tA, tB, tC, initial_state=ts0,
                    return_state=True)
    jy, jst = jref.ssd_ref(x, dt, A, B, C, initial_state=s0,
                           return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-4,
                               atol=1e-4)


def _jax_grads(arrays, use_final, use_init):
    """jax.grad of the reference's oracles: ``ssd_ref`` from the initial
    state where one is used, else ``ssd_ref_chunked`` on inputs zero-filled
    to its 128-step chunks (the padded steps add no decay and nothing to
    the state, and their gradients are cut off)."""
    x, dt, A, B, C, dy, d_final, s0 = (jnp.asarray(v) for v in arrays)
    t = x.shape[1]
    pad = -t % 128

    def cot(y, st):
        return jnp.sum(y * dy) + (jnp.sum(st * d_final) if use_final else 0.0)
    if use_init:
        def j_loss(x, dt, A, B, C, s0):
            return cot(*jref.ssd_ref(x, dt, A, B, C, initial_state=s0,
                                     return_state=True))
        return jax.grad(j_loss, argnums=(0, 1, 2, 3, 4, 5))(x, dt, A, B, C, s0)

    def j_loss(x, dt, A, B, C):
        def fill(v):
            return jnp.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
        y, st = jref.ssd_ref_chunked(fill(x), fill(dt), A, fill(B), fill(C),
                                     return_state=True)
        return cot(y[:, :t], st)
    return jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(x, dt, A, B, C)


@pytest.mark.parametrize("b,t,h,p,g,n,use_final,use_init", [
    (2, 150, 4, 8, 2, 8, True, True),       # G 2, ragged T, both states
    (2, 192, 4, 16, 1, 16, False, False),   # G 1, neither
    (1, 130, 2, 128, 1, 128, True, False),  # jamba's P 128, N 128, ragged
])
def test_chunk_parallel_backward_matches_the_walk_and_jax_grad(
        b, t, h, p, g, n, use_final, use_init):
    arrays = _inputs(b, t, h, p, g, n, seed=4)
    x, dt, A, B, C, dy, d_final, s0 = (torch.from_numpy(v) for v in arrays)
    d_final = d_final if use_final else None
    init = s0 if use_init else None
    starts = tref.ssd_chunk_parallel(x, dt, A, B, C, initial_state=init)[2]
    got = tref.ssd_chunked_bwd_parallel(x, dt, A, B, C, dy, starts,
                                        d_final=d_final, initial_state=init)
    walk = tref.ssd_chunked_bwd(x, dt, A, B, C, dy, starts, d_final=d_final,
                                initial_state=init)
    for name, o, w in zip(NAMES, got, walk):
        assert o.shape == w.shape and o.dtype == w.dtype, name
        assert _rel(o, w) <= PLAIN_TOL, (name, _rel(o, w))
    for name, o, w in zip(NAMES, got, _jax_grads(arrays, use_final,
                                                 use_init)):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def _stream_args():
    return dict(n_tasks=8, global_tokens=512, max_len=64, vocab=512,
                tail_fraction=0.1, tail_alpha=1.2, seed=0)


def test_sequential_runner_trains_mamba_like_the_reference():
    jcfg = dataclasses.replace(j_reduced(j_get_arch("mamba2-130m")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch("mamba2-130m")),
                               dtype="float32")
    stream = JStream(JStreamConfig(**_stream_args()))
    pal = JPalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
    pcfg = JPlannerConfig(n_stages=1, d_model=jcfg.d_model, palette=pal)
    rcfg = JRunnerConfig(n_iters=2, use_executor=False, log_every=0,
                         synchronous=True, impl="ref", seed=0)
    _, jhist, _ = JRunner(jcfg, JCost(jcfg, n_stages=1), pcfg, rcfg,
                          stream).run()
    jparams0 = JM.init_params(jax.random.PRNGKey(0), jcfg)   # the runner's
    tpal = ShapePalette.build(min_seq=32, max_seq=64, seq_align=32, max_mbs=4)
    runner = PlanAheadRunner(
        tcfg, AnalyticCostModel(tcfg, n_stages=1),
        PlannerConfig(n_stages=1, d_model=tcfg.d_model, palette=tpal),
        RunnerConfig(n_iters=2, use_executor=False, log_every=0,
                     device="cpu", synchronous=True),
        MultiTaskStream(StreamConfig(**_stream_args())),
        params=params_from_jax(jax.tree.map(np.asarray, jparams0),
                               device="cpu"))
    ops.reset_launch_counts()
    _, thist, _ = runner.run()
    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        assert {k: t[k] for k in ("iter", "n_micro", "tokens", "padded_tokens")} \
            == {k: j[k] for k in ("iter", "n_micro", "tokens", "padded_tokens")}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-4)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=2e-4)
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions

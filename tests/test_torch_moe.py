"""The port's MoE layer against ``repro.models.layers.moe_fwd``.

Configs: reduced granite-moe (4 experts of width 64, top-2, gated SiLU)
and reduced llama4-scout (top-1 and a shared expert), at float32 so the
comparison sees the algorithm and not bf16 rounding; a small
``capacity_factor`` makes the dispatch drop tokens. Weights are the
reference's ``init_moe`` carried across with ``params_from_jax``; inputs
are made with numpy. Routes (``top_i``) are compared exactly first: a
flipped route moves a token by a whole expert. Then y and aux within 3e-5,
the reference's f32 kernel tolerance (tests/test_kernels.py:28), and the
gradients within 2e-4, its f32 ``GRAD_TOL`` (tests/test_kernel_grads.py
:21): the two frameworks sum in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import flatten, unflatten

torch.set_num_threads(1)

TOL = 3e-5
GRAD_TOL = 2e-4
CASES = {
    # name: (arch, config overrides)
    "top2": ("granite-moe-3b-a800m", {}),
    "top1-shared": ("llama4-scout-17b-a16e", {}),
    "top2-dropping": ("granite-moe-3b-a800m", dict(capacity_factor=0.5)),
    "top2-relu-ungated": ("granite-moe-3b-a800m",
                          dict(mlp_gated=False, act="relu")),
}


def _cfgs(case):
    arch, kw = CASES[case]
    j = dataclasses.replace(j_reduced(j_get_arch(arch)), dtype="float32",
                            **kw)
    t = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    return j, t


def _setup(case, b=2, t=24, seed=0):
    jcfg, tcfg = _cfgs(case)
    p = JL.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, t, tcfg.d_model)).astype(np.float32)
    ct = r.standard_normal((b, t, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, tp, x, ct


def _close(out, ref, tol, what):
    np.testing.assert_allclose(
        out.detach().float().numpy() if isinstance(out, torch.Tensor)
        else np.asarray(out, np.float32),
        np.asarray(ref, np.float32), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_fwd_matches_reference(case):
    jcfg, tcfg, p, tp, x, ct = _setup(case)
    xf = x.reshape(-1, x.shape[-1])
    probs, top_p, top_i = TL.moe_route(torch.from_numpy(xf), tp["router"],
                                       tcfg)
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ p["router"], axis=-1)
    jtop_p, jtop_i = jax.lax.top_k(jprobs, jcfg.top_k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    _close(probs, jprobs, TOL, "router probs")
    _close(top_p, jtop_p / jtop_p.sum(-1, keepdims=True), TOL, "top_p")

    def jloss(p, x):
        y, aux = JL.moe_fwd(p, x, jcfg)
        return jnp.sum(y * ct) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    leaves = {k: v.requires_grad_() for k, v in flatten(tp)}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = TL.moe_fwd(tp, xt, tcfg)
    assert y.shape == x.shape and y.dtype == xt.dtype
    _close(y, jy, TOL, "y")
    _close(aux, jaux, TOL, "aux")
    ((y * torch.from_numpy(ct)).sum() + aux).backward()
    _close(xt.grad, jgx, GRAD_TOL, "dx")
    for name, g in flatten(jgp):
        _close(leaves[name].grad, g, GRAD_TOL, f"d{'/'.join(name)}")


def _slots_loop(top_i, e, k, cap):
    """The dispatch written as the loop it stands for: choice j of every
    token in token order, then choice j + 1; a choice past its expert's
    cap slots is dropped."""
    used = [0] * e
    dest = np.full(top_i.shape, e * cap)
    for j in range(k):
        for tok in range(top_i.shape[0]):
            ex = int(top_i[tok, j])
            if used[ex] < cap:
                dest[tok, j] = ex * cap + used[ex]
            used[ex] += 1
    return dest


@pytest.mark.parametrize("cap", [8, 16, 64])
def test_slots_fill_experts_in_order_and_drop_past_capacity(cap):
    _, tcfg = _cfgs("top2")
    r = np.random.default_rng(cap)
    n, e, k = 96, tcfg.n_experts, tcfg.top_k
    # skewed routes: expert 0 takes about half the first choices
    first = np.where(r.random(n) < 0.5, 0, r.integers(1, e, n))
    second = (first + r.integers(1, e, n)) % e
    top_i = torch.from_numpy(np.stack([first, second], 1))
    dests, keeps = TL.moe_slots(top_i, tcfg, cap)
    assert dests.shape == keeps.shape == (k, n)
    got = dests.t().numpy()
    np.testing.assert_array_equal(got, _slots_loop(top_i.numpy(), e, k, cap))
    kept = got[got < e * cap]
    assert len(np.unique(kept)) == len(kept)           # kept slots unique
    np.testing.assert_array_equal(keeps.t().numpy(), got < e * cap)
    if cap == 8:
        assert (got == e * cap).any()


def test_capacity_counts_padding_tokens_and_aligns_to_8():
    _, tcfg = _cfgs("top2")      # 4 experts, top-2, capacity_factor 1.25
    assert TL.moe_capacity(1, tcfg) == 8          # at least 8
    assert TL.moe_capacity(48, tcfg) == 32        # ceil(48*2/4*1.25) = 30
    assert TL.moe_capacity(100, tcfg) == 64       # 62.5 -> 63 -> 64
    # padding rows take slots: capacity follows B*T, not the real tokens;
    # zero rows route with every probability equal, and the ties go to the
    # lower experts, as jax.lax.top_k breaks them
    jcfg, tcfg, p, tp, x, _ = _setup("top2-dropping", b=2, t=24)
    x[1, 12:] = 0.0
    y, _ = TL.moe_fwd(tp, torch.from_numpy(x), tcfg)
    jy, _ = JL.moe_fwd(p, jnp.asarray(x), jcfg)
    _close(y, jy, TOL, "y with zero padding rows")


def test_moe_route_is_what_the_layer_calls():
    # the routing is one patchable function: a replay that forces every
    # token onto experts (0, 1) with equal weights changes y accordingly
    _, tcfg, _, tp, x, _ = _setup("top2")
    xt = torch.from_numpy(x)
    real = TL.moe_route

    def forced(xf, router, cfg):
        probs, _, _ = real(xf, router, cfg)
        n = xf.shape[0]
        top_i = torch.tensor([[0, 1]] * n)
        return probs, torch.full((n, 2), 0.5), top_i
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "moe_route", forced)
        y, _ = TL.moe_fwd(tp, xt, tcfg)
    xf = xt.reshape(-1, tcfg.d_model)

    def expert(i):
        h = torch.nn.functional.silu(xf @ tp["w_gate"][i]) * (
            xf @ tp["w_in"][i])
        return h @ tp["w_out"][i]
    # capacity ceil(48*2/4*1.25) = 32 slots: tokens 32.. of each expert drop
    want = 0.5 * (expert(0) + expert(1))
    want[32:] = 0.0
    _close(y.reshape(-1, tcfg.d_model), want, TOL, "forced routes")


def test_block_and_stack_sum_the_aux_terms():
    # jamba's period: mamba and attention mixers, MoE on odd layers; the
    # stack's aux is the sum of the four MoE layers' terms
    jcfg = dataclasses.replace(j_reduced(j_get_arch("jamba-1.5-large-398b")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch("jamba-1.5-large-398b")),
                               dtype="float32")
    jstack = JT.init_stack(jax.random.PRNGKey(3), jcfg)
    tstack = params_from_jax(jax.tree.map(np.asarray, jstack), device="cpu")
    h = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jh, _, jaux = jax.jit(lambda s, h: JT.stack_fwd(
        s, h, jcfg, positions=jnp.asarray(pos), segment_ids=None,
        impl="ref"))(jstack, jnp.asarray(h))
    th, cache, taux = TT.stack_fwd(tstack, torch.from_numpy(h), tcfg,
                                   positions=torch.from_numpy(pos.copy()),
                                   segment_ids=None)
    assert cache is None
    _close(th, jh, GRAD_TOL, "jamba period h")
    _close(taux, jaux, TOL, "jamba period aux")
    per_layer = []
    x = torch.from_numpy(h)
    for j, spec in enumerate(tcfg.layer_pattern):
        p = {k: v[0] for k, v in flatten(tstack[f"l{j}"])}
        x, _, a = TT.block_fwd(unflatten(p.items()), x, tcfg, spec,
                               positions=torch.from_numpy(pos.copy()),
                               segment_ids=None)
        assert (a is None) == (not spec.moe)
        if a is not None:
            per_layer.append(float(a))
    assert len(per_layer) == 4
    np.testing.assert_allclose(float(taux), sum(per_layer), rtol=1e-6)

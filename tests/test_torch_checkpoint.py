"""The port's format-2 checkpoints against the reference's.

A checkpoint written by either package loads in the other, bit for bit,
with every CRC verified: the reduced gpt-paper state (bf16 params, fp32
master, m and v, the int ``step``) after one AdamW update. The port
restores in place: every tensor keeps its identity. Then the reference's
own checkpoint tests (``tests/test_fault_tolerance.py``) on the port's
module, and the port's verify-before-copy rule: a step that fails to load
leaves the live tree untouched.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch, reduced as j_reduced
from repro.models import model as JM
from repro.train import checkpoint as JCKPT
from repro.train import optimizer as JO
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as TO
from repro_torch.tree import flatten, tree_map

torch.set_num_threads(2)

JCFG = dataclasses.replace(j_reduced(j_get_arch("gpt-paper")), n_layers=2)
TCFG = dataclasses.replace(reduced(get_arch("gpt-paper")), n_layers=2)
OPT = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf of either package, for equality to the bit."""
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bitwise(tree_a, tree_b):
    fa = {"/".join(p): x for p, x in flatten(tree_a)}
    fb = {"/".join(map(str, p)): x for p, x in flatten(tree_b)}
    assert sorted(fa) == sorted(fb)
    for k in fa:
        a, b = _bits(fa[k]), _bits(fb[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _jax_flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree.flatten_with_path(tree)[0]:
        out["/".join(str(p.key) for p in path)] = leaf
    return out


def _port_state(seed=0):
    """Port params, and an optimizer state after one AdamW update."""
    params = TM.init_params(torch.Generator().manual_seed(seed), TCFG,
                            device="cpu")
    opt = TO.init_opt_state(params, TO.AdamWConfig(**OPT))
    g = torch.Generator().manual_seed(seed + 1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g)
                     .to(p.dtype), params)
    params, opt, _ = TO.adamw_update(params, grads, opt, TO.AdamWConfig(**OPT))
    return {"params": params, "opt": opt}


def test_port_checkpoint_loads_in_the_reference_bit_for_bit(tmp_path):
    state = _port_state()
    assert state["opt"]["step"] == 1
    CKPT.save(tmp_path, 1, state)

    def init():
        jparams = JM.init_params(jax.random.PRNGKey(0), JCFG)
        return {"params": jparams,
                "opt": JO.init_opt_state(jparams, JO.AdamWConfig(**OPT))}
    like = jax.eval_shape(init)
    loaded, manifest = JCKPT.load(tmp_path, like, 1)   # CRCs verified
    assert manifest["format"] == 2 and manifest["step"] == 1
    jflat = _jax_flat(loaded)
    tflat = {"/".join(p): x for p, x in flatten(state)}
    assert sorted(jflat) == sorted(tflat)
    for k, t in tflat.items():
        j = jflat[k]
        want = ("int32" if isinstance(t, int)
                else str(t.dtype).removeprefix("torch."))
        assert str(j.dtype) == want, k
        assert tuple(j.shape) == (tuple(t.shape) if not isinstance(t, int)
                                  else ()), k
        np.testing.assert_array_equal(_bits(j), _bits(t), err_msg=k)
    assert int(jflat["opt/step"]) == 1


def test_reference_checkpoint_restores_in_place_bit_for_bit(tmp_path):
    jparams = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), JCFG)
    ocfg = JO.AdamWConfig(**OPT)
    jopt = jax.jit(JO.init_opt_state, static_argnums=1)(jparams, ocfg)
    r = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: jnp.asarray(
        r.standard_normal(p.shape).astype(np.float32)).astype(p.dtype),
        jparams)
    for _ in range(2):
        jparams, jopt, _ = jax.jit(JO.adamw_update, static_argnums=3)(
            jparams, grads, jopt, ocfg)
    JCKPT.save(tmp_path, 2, {"params": jparams, "opt": jopt})

    live = _port_state(seed=7)             # other values, same structure
    ptrs = {"/".join(p): x.data_ptr() for p, x in flatten(live)
            if isinstance(x, torch.Tensor)}
    state, manifest = CKPT.load(tmp_path, live)
    assert manifest["step"] == 2 and state["opt"]["step"] == 2
    assert isinstance(state["opt"]["step"], int)
    for p, x in flatten(state):
        if isinstance(x, torch.Tensor):
            assert x.data_ptr() == ptrs["/".join(p)], p   # restored in place
    _assert_bitwise(state, {"params": jax.tree.map(np.asarray, jparams),
                            "opt": jax.tree.map(np.asarray, jopt)})
    # and the live tensors themselves hold the reference's values
    _assert_bitwise(live["params"], jax.tree.map(np.asarray, jparams))


def test_port_round_trip_in_place_keeps_identity(tmp_path):
    state = _port_state()
    want = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                    state)
    CKPT.save(tmp_path, 1, state)
    tree_map(lambda x: x.zero_() if isinstance(x, torch.Tensor) else x, state)
    state["opt"]["step"] = 0
    got, _ = CKPT.load(tmp_path, state)
    _assert_bitwise(got, want)
    for (_, a), (_, b) in zip(flatten(got), flatten(state)):
        assert a is b or isinstance(a, int)


# ------------------------------------------- the reference's own tests --
def _tree(seed=0, n=3):
    g = torch.Generator().manual_seed(seed)
    return {f"w{i}": torch.randn(4, 4, generator=g) for i in range(n)}


def test_restore_or_init_leaf_count_mismatch_falls_back(tmp_path):
    CKPT.save(tmp_path, 5, _tree(n=3))
    with pytest.warns(UserWarning):
        state, start = CKPT.restore_or_init(tmp_path, lambda: _tree(1, n=5))
    assert start == 0 and len(state) == 5   # fresh init, not truncated zip
    for k, x in state.items():
        assert torch.equal(x, _tree(1, n=5)[k])


def test_save_sweeps_stale_tmp_dirs_but_not_a_live_writers(tmp_path):
    # a provably dead writer (a reaped child), not an arbitrary number that
    # may be someone's live pid
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait(timeout=30)
    stale = tmp_path / f".tmp-3-{child.pid}-deadbeef"
    stale.mkdir(parents=True)
    (stale / "junk.npy").write_bytes(b"torn")
    live = tmp_path / f".tmp-4-{os.getpid()}-0badf00d"   # this process
    live.mkdir()
    CKPT.save(tmp_path, 1, _tree())
    assert not stale.exists()
    assert live.exists()
    assert CKPT.latest_step(tmp_path) == 1


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    t = _tree()
    CKPT.save(tmp_path, 1, t, keep=5)
    CKPT.save(tmp_path, 2, _tree(seed=9), keep=5)
    latest = tmp_path / "step_00000002"
    leaf = next(latest.glob("*.npy"))
    leaf.write_bytes(leaf.read_bytes()[:16])          # truncate one leaf
    live = _tree(seed=5)
    with pytest.warns(UserWarning, match="step 2"):
        state, manifest = CKPT.load_latest_valid(tmp_path, live)
    assert manifest["step"] == 1
    assert torch.equal(state["w0"], t["w0"]) and state["w0"] is live["w0"]
    with pytest.warns(UserWarning):
        _, start = CKPT.restore_or_init(tmp_path, lambda: _tree(seed=2))
    assert start == 1


def test_checksum_detects_bitflip(tmp_path):
    t = _tree()
    CKPT.save(tmp_path, 1, t)
    leaf = next((tmp_path / "step_00000001").glob("*.npy"))
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF                       # flip data bits, keep the header
    leaf.write_bytes(bytes(raw))
    with pytest.raises(CKPT.CheckpointCorruptError, match="checksum"):
        CKPT.load(tmp_path, t, 1)


def test_load_rejects_leaf_superset(tmp_path):
    CKPT.save(tmp_path, 1, _tree(n=4))
    with pytest.raises(KeyError, match="leaf set mismatch"):
        CKPT.load(tmp_path, _tree(n=2), 1)


# ------------------------------------------------ the port's own rules --
def test_a_failed_load_leaves_the_live_tree_untouched(tmp_path):
    """Every CRC is checked before the first copy: a corrupt last leaf
    must not leave the earlier leaves restored and the rest not."""
    CKPT.save(tmp_path, 1, _tree(seed=1))
    last = tmp_path / "step_00000001" / "w2.npy"
    raw = bytearray(last.read_bytes())
    raw[-1] ^= 0x01
    last.write_bytes(bytes(raw))
    live = _tree(seed=2)
    before = {k: x.clone() for k, x in live.items()}
    with pytest.raises(CKPT.CheckpointCorruptError, match="w2"):
        CKPT.load(tmp_path, live, 1)
    for k in live:
        assert torch.equal(live[k], before[k]), k


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_load_refuses_a_leaf_that_does_not_fit_its_tensor(tmp_path, bad):
    CKPT.save(tmp_path, 1, _tree())
    live = _tree()
    live["w1"] = (torch.zeros(4, 5) if bad == "shape"
                  else torch.zeros(4, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="w1"):
        CKPT.load(tmp_path, live, 1)


def test_save_reports_its_timings_and_bytes(tmp_path):
    t = {"a": torch.zeros(3, 5, dtype=torch.bfloat16), "b": torch.ones(7),
         "step": 12}
    timings: dict = {}
    CKPT.save(tmp_path, 4, t, timings=timings)
    assert timings["bytes"] == 3 * 5 * 2 + 7 * 4 + 4
    assert {"sync_s", "d2h_s", "crc_s", "write_s"} <= set(timings)
    loaded, _ = CKPT.load(tmp_path, {"a": torch.empty(3, 5,
                                                      dtype=torch.bfloat16),
                                     "b": torch.empty(7), "step": 0},
                          timings=timings)
    assert loaded["step"] == 12 and torch.equal(loaded["b"], t["b"])
    assert timings["load_s"] > 0

"""K1's decode form split and merged, in plain PyTorch, against the JAX
reference's Pallas kernel run in interpret mode.

For T ≤ 16 the CUDA kernel cuts each batch row's live 64-key tiles into
``n_split`` ranges, computes a partial (acc, m, l) per range and merges the
ranges in ascending order. Here the same inputs, made once from a numpy
seed, go through the port's split plan (``decode_live_tiles``,
``decode_split_tiles``), one plain partial per split
(``decode_partial_plain``) and the plain merge (``decode_merge_plain``),
and the result is held to ``repro.kernels.flash_attention.mha_forward``.
The kernel itself is held to the port's plain forward on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are those of ``tests/test_torch_attention.py`` for K1, the
reference's own kernel-test ``TOL`` (tests/test_kernels.py:28): 3e-5 in
f32 (summation order only) and 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa

# Tiny tensors: one intra-op thread, so that pytest-xdist's workers do not
# oversubscribe the CPU (idle OpenMP threads spin) and slow the wall-clock
# tests of other files.
torch.set_num_threads(1)

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name: (b, t, h, kv, d, s, opts, query positions per row (the last
# position of each row's T), segmented, n_split); n_split None takes the
# host plan's on a card of 132 SMs
CASES = {
    "g1-t1-d64": (3, 1, 2, 2, 64, 2056, dict(causal=True),
                  [2055, 1000, 37], False, 1),
    "g2-t1-d256-window-softcap-plan": (
        2, 1, 4, 2, 256, 2056, dict(causal=True, window=1200, softcap=50.0),
        [2055, 1500], False, None),
    "g3-t1-d64-splits-past-live": (2, 1, 3, 1, 64, 2056, dict(causal=True),
                                   [2055, 300], False, 40),
    "g7-t1-d256-softcap": (2, 1, 7, 1, 256, 2056,
                           dict(causal=True, softcap=50.0), [2055, 777],
                           False, 8),
    "g2-t1-d64-s40-noncausal": (2, 1, 4, 2, 64, 40, dict(causal=False),
                                [39, 39], False, 1),
    "g3-t1-d256-segmented": (3, 1, 6, 2, 256, 2056, dict(causal=True),
                             [1500, 900, 2055], True, 3),
    "g1-t16-d256-window": (2, 16, 2, 2, 256, 2056,
                           dict(causal=True, window=1100), [2055, 1800],
                           False, 5),
    "g2-t16-d64-softcap": (2, 16, 4, 2, 64, 2056,
                           dict(causal=True, softcap=50.0), [2055, 1024],
                           False, 4),
    "g7-t16-d64": (2, 16, 14, 2, 64, 2056, dict(causal=True), [2055, 630],
                   False, 3),
    "g7-t16-d256-s40-splits-past-live": (2, 16, 7, 1, 256, 40,
                                         dict(causal=True), [39, 20],
                                         False, 2),
    "g3-t16-d64-window-splits-past-live": (
        2, 16, 3, 1, 64, 2056, dict(causal=True, window=1500), [2055, 1700],
        False, 30),
    "g2-t16-d256-segmented-plan": (2, 16, 4, 2, 256, 2056,
                                   dict(causal=True, softcap=50.0),
                                   [1200, 2055], True, None),
}


def _inputs(case):
    """numpy arrays of a case: q, k, v, positions and segment ids. Segmented
    cases: batch row 0 holds a sample over keys [0, 1400) and its query
    rows are the sample's last positions, except the first two, which are
    padding (segment -1, so they see no key); row 1's queries are all
    padding; any further row is one sample over the whole cache."""
    b, t, h, kv, d, s, opts, last, segmented, _ = CASES[case]
    r = np.random.default_rng(sum(map(ord, case)))
    q = r.standard_normal((b, t, h, d), np.float32)
    k = r.standard_normal((b, s, kv, d), np.float32)
    v = r.standard_normal((b, s, kv, d), np.float32)
    qpos = np.stack([np.arange(p - t + 1, p + 1) for p in last]).astype(np.int32)
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    qseg = kseg = None
    if segmented:
        qseg = np.zeros((b, t), np.int32)
        kseg = np.zeros((b, s), np.int32)
        kseg[0, 1400:] = -1
        qpos[0] = np.arange(1400 - t, 1400)
        qseg[0, :min(2, t)] = -1
        qseg[1] = -1
    return q, k, v, qpos, kpos, qseg, kseg, opts


def _torch(x):
    if x is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(x))


def _split(case, n_sm=132):
    """The live tiles and the split plan of a case."""
    b, t, h, kv, d, s, _, _, _, n_split = CASES[case]
    q, k, v, qpos, kpos, qseg, kseg, opts = _inputs(case)
    live = tfa.decode_live_tiles(qpos, kpos, qseg, kseg,
                                 causal=opts["causal"],
                                 window=opts.get("window", 0))
    if n_split is None:
        n_split = tfa.decode_plan(b, t, h, kv, s, d, n_sm)[1]
    return live, n_split, tfa.decode_split_tiles(live, n_split)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_and_merge_match_reference(case, dtype):
    q, k, v, qpos, kpos, qseg, kseg, opts = _inputs(case)
    b, t, h = q.shape[:3]
    _, n_split, tiles = _split(case)
    tq, tk, tv = (_torch(x).to(TORCH[dtype]) for x in (q, k, v))
    args = (tq, tk, tv, _torch(qpos), _torch(kpos), _torch(qseg), _torch(kseg))
    parts = [tfa.decode_partial_plain(*args, tiles[j], **opts)
             for j in range(n_split)]
    o, lse = tfa.decode_merge_plain(parts, dtype=TORCH[dtype])

    jq, jk, jv = (jnp.asarray(x).astype(JNP[dtype]) for x in (q, k, v))
    jseg = (None, None) if qseg is None else (jnp.asarray(qseg), jnp.asarray(kseg))
    # the reference's key blocks: 257 keys, an eighth of 2056 (40 keys
    # shrink to one block); its grid runs step by step in interpret mode
    jo, jl = jfa.mha_forward(jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos),
                             *jseg, **opts, block_q=t, block_kv=257,
                             interpret=True)
    assert o.shape == (b, t, h, q.shape[3]) and o.dtype == TORCH[dtype]
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    for name, out, ref in (("o", o, jo), ("lse", lse, jl)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=f"{case}: {name}")
    if qseg is not None:   # query rows of padding see no key
        dead = torch.from_numpy(qseg < 0)
        assert dead.any()
        assert (o[dead] == 0).all()
        assert (lse.permute(0, 2, 1)[dead] < -1e29).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_splits_cover_the_live_tiles_once_in_order(case):
    # the union of the splits' tiles is the row's live tiles, each once, in
    # ascending order, against the port's live_block_mask at the kernel's
    # tiles: the keys past S are padded with the row's last key, which
    # leaves each tile's min and max as its keys up to S give them
    q, k, v, qpos, kpos, qseg, kseg, opts = _inputs(case)
    b, t = qpos.shape
    s = kpos.shape[1]
    live, n_split, tiles = _split(case)
    n = -(-s // tfa.DECODE_TILE)
    pad = n * tfa.DECODE_TILE - s

    def edge(x):
        return None if x is None else np.pad(x, ((0, 0), (0, pad)), mode="edge")
    ref = tfa.live_block_mask(qpos, edge(kpos), qseg, edge(kseg),
                              causal=opts["causal"],
                              window=opts.get("window", 0), block_q=t,
                              block_kv=tfa.DECODE_TILE)[:, 0, :]
    np.testing.assert_array_equal(live, ref)
    for r in range(b):
        got = np.concatenate([tiles[j][r] for j in range(n_split)])
        np.testing.assert_array_equal(got, np.flatnonzero(ref[r]))
        sizes = [len(tiles[j][r]) for j in range(n_split)]
        assert max(sizes) - min(sizes) <= 1   # balanced to one tile


# (b, t, h, kv, s, d): the serve paths' decode shapes and the extremes
PLAN_SHAPES = [
    (16, 1, 8, 4, 8200, 256),    # gemma2-decode
    (8, 1, 8, 4, 2064, 256),     # gemma2-2b's serve decode
    (8, 1, 24, 8, 2064, 64),     # granite-moe's
    (4, 1, 56, 8, 3400, 128),    # llava-next's
    (16, 1, 32, 32, 2056, 128),  # gpt-paper, MHA: enough blocks already
    (4, 16, 56, 8, 3400, 128),   # G 7 x T 16: two row groups
    (2, 16, 8, 1, 2056, 256),    # G 8 x T 16 at D 256: four row groups
    (1, 1, 2, 1, 40, 64),        # one tile
]


@pytest.mark.parametrize("b,t,h,kv,s,d", PLAN_SHAPES)
def test_decode_plan_fills_the_card_within_its_limits(b, t, h, kv, s, d):
    gh, n_split = tfa.decode_plan(b, t, h, kv, s, d, 132)
    g = h // kv
    cap = 32 if d > 128 else 64
    assert 1 <= gh <= g and gh * t <= cap
    if g * t <= cap:
        assert gh == g          # the whole group in one block
    blocks = b * kv * -(-g // gh)
    n_tiles = -(-s // tfa.DECODE_TILE)
    assert 1 <= n_split <= max(1, n_tiles // 2)
    assert blocks * n_split <= max(blocks, 2 * 132)
    if n_split < n_tiles // 2:  # limited by the card, not the cache
        assert blocks * (n_split + 1) > 2 * 132
    # a pure function of the shapes and the SM count
    assert tfa.decode_plan(b, t, h, kv, s, d, 132) == (gh, n_split)
    assert tfa.decode_workspace_numel(n_split, b, t, h, kv, d, gh) == (
        0 if n_split == 1 else n_split * b * t * h * (d + 2) + blocks)

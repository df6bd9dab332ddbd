"""The CUDA kernels K1, the fused backward (K2 and K3) and K4 on the card,
against their plain versions and the CPU.

Marked ``cuda``: each test skips where there is no card. On a machine with
one they run with ``PYTHONPATH=src python -m pytest -q -m cuda --noconftest
tests/test_torch_cuda.py`` (the repo's conftest imports the JAX package,
which such a machine need not have); ``chip_smoke.py`` checks the same at
the serving and training paths' full widths. Tolerances: 2e-2 for the
forward, the reference's bf16 kernel tolerance (tests/test_kernels.py:28):
the kernel rounds p to bf16 before p·v, the plain version does not; 4e-2 for
gradients, the reference's bf16 ``GRAD_TOL`` (tests/test_kernel_grads.py:21),
where p and ds are rounded to bf16 before the second products; 5e-2 for
K4 (SSD), the reference's bf16 SSD tolerance (tests/test_kernels.py:193):
its chunks are 64 steps, the plain version's 128, and y is rounded to bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch import serve as SV
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as SSD
from repro_torch.models import model as MD

pytestmark = pytest.mark.cuda
TOL = 2e-2
GRAD_TOL = 4e-2
SSD_TOL = 5e-2
# ||grad card - grad CPU|| / ||grad CPU|| per leaf of a reduced jamba period
# (test_jamba_period_gradients_on_the_card_match_the_cpu says why)
JAMBA_GRAD_TOL = 1e-1

# Where a CPU reference runs: one intra-op thread, so that pytest-xdist's
# workers do not oversubscribe the CPU (idle OpenMP threads spin) and slow
# the wall-clock tests of other files.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    return torch.device("cuda")


def _inputs(dev, b, t, s, h, kv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    pos = torch.arange(max(t, s), dtype=torch.int32, device=dev)
    return (q, k, v, pos[None, :t].expand(b, t).contiguous(),
            pos[None, :s].expand(b, s).contiguous())


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 200, 256])
@pytest.mark.parametrize("t,s,h,kv,opts", [
    (130, 130, 4, 2, dict(causal=True)),
    (70, 190, 2, 1, dict(causal=False)),
    (1, 333, 4, 4, dict(causal=True)),
    (200, 200, 4, 4, dict(causal=True, window=50, softcap=3.0)),
])
def test_kernel_matches_plain_version(cuda, d, t, s, h, kv, opts):
    q, k, v, qp, kp = _inputs(cuda, 2, t, s, h, kv, d)
    if t == 1:
        qp = torch.full_like(qp, 200)     # decode: one token mid-cache
    o, lse = fa.mha_forward(q, k, v, qp, kp, **opts)
    o_ref, lse_ref = fa.mha_forward_plain(q, k, v, qp, kp, **opts)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=TOL)


# K1's prefill form (T > 16): one block per 128 query rows
PREFILL_CASES = {
    # name: (t, s, h, kv, opts); query positions 0..T-1, key positions 0..S-1
    "t17": (17, 17, 4, 2, dict(causal=True)),       # just past decode
    "cache": (129, 145, 4, 4, dict(causal=True)),   # prefill into a cache
    "gqa4": (256, 256, 8, 2, dict(causal=True)),    # a GQA group of 4
    "window_softcap": (300, 300, 4, 2, dict(causal=True, window=64,
                                             softcap=5.0)),
}


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_kernel_matches_plain_version(cuda, d, case):
    t, s, h, kv, opts = PREFILL_CASES[case]
    q, k, v, qp, kp = _inputs(cuda, 2, t, s, h, kv, d)
    ops.reset_launch_counts()
    o, lse = fa.mha_forward(q, k, v, qp, kp, **opts)
    assert ops.launch_counts()["mha_forward"] == 1
    o_ref, lse_ref = fa.mha_forward_plain(q, k, v, qp, kp, **opts)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 256])
def test_prefill_kernel_query_tile_of_pure_padding(cuda, d):
    # row 0: a sample of 100 tokens, then padding, so that its query rows
    # 128..255 are a whole tile with no visible key; row 1: a sample of 200
    q, k, v, _, _ = _inputs(cuda, 2, 256, 256, 4, 2, d)
    seg = torch.full((2, 256), -1, dtype=torch.int32, device=cuda)
    pos = torch.zeros_like(seg)
    for row, n in enumerate((100, 200)):
        seg[row, :n] = 0
        pos[row, :n] = torch.arange(n, device=cuda)
    o, lse = fa.mha_forward(q, k, v, pos, pos, seg, seg, causal=True)
    o_ref, lse_ref = fa.mha_forward_plain(q, k, v, pos, pos, seg, seg,
                                          causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=TOL)
    assert (o[0, 128:] == 0).all() and (lse[0, :, 128:] < -1e29).all()
    dead = seg < 0
    assert (o[dead] == 0).all() and (lse.permute(0, 2, 1)[dead] < -1e29).all()


def test_kernel_segmented_with_fully_masked_rows(cuda):
    q, k, v, _, _ = _inputs(cuda, 2, 96, 96, 4, 2, 128)
    seg = torch.full((2, 96), -1, dtype=torch.int32, device=cuda)
    seg[0, :40], seg[0, 40:70], seg[1, :20] = 0, 1, 2
    pos = torch.zeros_like(seg)
    pos[0, :40] = torch.arange(40, device=cuda)
    pos[0, 40:70] = torch.arange(30, device=cuda)
    pos[1, :20] = torch.arange(20, device=cuda)
    o, lse = fa.mha_forward(q, k, v, pos, pos, seg, seg, causal=True)
    o_ref, lse_ref = fa.mha_forward_plain(q, k, v, pos, pos, seg, seg,
                                          causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=TOL)
    dead = seg < 0
    assert (o[dead] == 0).all() and (lse.permute(0, 2, 1)[dead] < -1e29).all()


# K1's decode form (T <= 16): one block per (cache split, KV head, batch
# row) over the GQA group's G x T rows, the splits merged in a fixed order.
# variant: (b, s, opts, segmented); query positions: row r's T queries end
# at s - 1 - 517 r
DECODE_VARIANTS = {
    "causal": (2, 2056, dict(causal=True), False),
    "window": (2, 2056, dict(causal=True, window=700), False),
    "softcap": (2, 2056, dict(causal=True, softcap=50.0), False),
    # row 0 a sample over keys [0, 1400) whose first two query rows are
    # padding (they see no key), row 1 all padding, row 2 one sample
    "segmented": (3, 2056, dict(causal=True), True),
    # past the 32768 keys of 512 tile statistics: 20 words of tile bits
    "keys-40960": (1, 40960, dict(causal=True), False),
}


def _decode_inputs(dev, variant, g, t, d, kv=2, seed=5):
    b, s, opts, segmented = DECODE_VARIANTS[variant]
    q, k, v, _, kp = _inputs(dev, b, t, s, g * kv, kv, d, seed=seed)
    last = torch.tensor([s - 1 - 517 * r for r in range(b)], device=dev)
    qp = (last[:, None] - t + 1 + torch.arange(t, device=dev)).to(torch.int32)
    qs = ks = None
    if segmented:
        qs = torch.zeros((b, t), dtype=torch.int32, device=dev)
        ks = torch.zeros((b, s), dtype=torch.int32, device=dev)
        ks[0, 1400:] = -1
        qp[0] = torch.arange(1400 - t, 1400, device=dev)
        qs[0, :min(2, t)] = -1
        qs[1] = -1
    return (q, k, v, qp.contiguous(), kp, qs, ks), opts


def _check_decode(args, opts):
    """K1 once (one counted launch) against the plain version, then again
    equal to the bit; rows of padding give o = 0 and the lse sentinel."""
    ops.reset_launch_counts()
    o, lse = fa.mha_forward(*args, **opts)
    assert ops.launch_counts()["mha_forward"] == 1
    o_ref, lse_ref = fa.mha_forward_plain(*args, **opts)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=TOL)
    again = fa.mha_forward(*args, **opts)
    assert ops.launch_counts()["mha_forward"] == 2
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    qs = args[5]
    if qs is not None:
        dead = qs < 0
        assert (o[dead] == 0).all()
        assert (lse.permute(0, 2, 1)[dead] < -1e29).all()


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("g", [1, 2, 3, 5, 7])
def test_decode_form_matches_plain_version(cuda, g, t, d):
    # G 7 x T 16 = 112 rows: two row groups (one at D 256 would be 32 rows)
    args, opts = _decode_inputs(cuda, "causal", g, t, d)
    _check_decode(args, opts)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("variant", ["window", "softcap", "segmented",
                                     "keys-40960"])
def test_decode_form_variants_match_plain_version(cuda, variant, t, d):
    g = {"window": 2, "softcap": 7, "segmented": 3, "keys-40960": 5}[variant]
    args, opts = _decode_inputs(cuda, variant, g, t, d)
    _check_decode(args, opts)


def test_decode_form_refuses_a_workspace_of_another_size(cuda):
    args, opts = _decode_inputs(cuda, "causal", 2, 1, 128)
    q, k = args[0], args[1]
    b, t, h, d = q.shape
    gh, n_split = fa.decode_plan(b, t, h, k.shape[2], k.shape[1], d,
                                 fa.sm_count(q.device))
    assert n_split > 1
    need = fa.decode_workspace_numel(n_split, b, t, h, k.shape[2], d, gh)
    o, lse = torch.empty_like(q), torch.empty((b, h, t), device=cuda)
    for ws in (torch.zeros(need - 1, device=cuda), None,
               torch.zeros(need, device=cuda, dtype=torch.float64)):
        with pytest.raises(ValueError, match="workspace"):
            fa._launch_forward(*args, o, lse, ws, **opts, window=0,
                               softcap=None, sm_scale=fa.softmax_scale(d),
                               n_split=n_split, heads_per_block=gh)
    # the counters zeroed once: the kernel leaves them at zero, so the
    # workspace serves a second launch, which repeats the first to the bit
    ws = torch.zeros(need, device=cuda)
    outs = []
    for _ in range(2):
        o, lse = torch.empty_like(q), torch.empty((b, h, t), device=cuda)
        fa._launch_forward(*args, o, lse, ws, **opts, window=0, softcap=None,
                           sm_scale=fa.softmax_scale(d), n_split=n_split,
                           heads_per_block=gh)
        outs.append((o, lse))
    o_ref, _ = fa.mha_forward_plain(*args, **opts)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    counters = ws[n_split * b * t * h * (d + 2):].view(torch.int32)
    assert counters.numel() == b * k.shape[2] and (counters == 0).all()


def test_kernel_refuses_a_gradient(cuda):
    # a gradient the kernels cannot take (fp32) raises; it never falls back
    # to the plain backward
    q, k, v, qp, kp = _inputs(cuda, 1, 8, 8, 2, 2, 16)
    q, k, v = (x.float().requires_grad_() for x in (q, k, v))
    with pytest.raises(TypeError, match="bf16"):
        ops.attention(q, k, v, q_positions=qp, kv_positions=kp)


def _grad_close(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), atol=GRAD_TOL,
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 200, 256])
@pytest.mark.parametrize("t,s,h,kv,opts", [
    (130, 130, 4, 2, dict(causal=True)),
    (70, 190, 2, 1, dict(causal=False)),
    (200, 200, 4, 4, dict(causal=True, window=50, softcap=3.0)),
    (256, 256, 8, 2, dict(causal=True)),            # a GQA group of 4
    (150, 333, 4, 1, dict(causal=False)),           # ragged T != S, group 4
    (97, 211, 2, 2, dict(causal=True)),             # ragged T != S, causal
])
def test_backward_kernels_match_plain_version(cuda, d, t, s, h, kv, opts):
    q, k, v, qp, kp = _inputs(cuda, 2, t, s, h, kv, d)
    o, lse = fa.mha_forward(q, k, v, qp, kp, **opts)
    do = torch.randn_like(o)
    ops.reset_launch_counts()
    out = fa.mha_backward(q, k, v, qp, kp, None, None, o, lse, do, **opts)
    assert ops.launch_counts() == {"mha_forward": 0, "mha_backward": 1,
                                   "ssd_chunked": 0, "ssd_backward": 0}
    ref = fa.mha_backward_plain(q, k, v, qp, kp, None, None, o, lse, do,
                                **opts)
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype == torch.bfloat16
        _grad_close(a, r)


def test_backward_kernels_segmented_with_fully_masked_rows(cuda):
    q, k, v, _, _ = _inputs(cuda, 2, 96, 96, 4, 2, 128)
    seg = torch.full((2, 96), -1, dtype=torch.int32, device=cuda)
    seg[0, :40], seg[0, 40:70], seg[1, :20] = 0, 1, 2
    pos = torch.zeros_like(seg)
    pos[0, :40] = torch.arange(40, device=cuda)
    pos[0, 40:70] = torch.arange(30, device=cuda)
    pos[1, :20] = torch.arange(20, device=cuda)
    o, lse = fa.mha_forward(q, k, v, pos, pos, seg, seg, causal=True)
    do = torch.randn_like(o)
    dq, dk, dv = fa.mha_backward(q, k, v, pos, pos, seg, seg, o, lse, do,
                                 causal=True)
    ref = fa.mha_backward_plain(q, k, v, pos, pos, seg, seg, o, lse, do,
                                causal=True)
    for a, r in zip((dq, dk, dv), ref):
        _grad_close(a, r)
    dead = seg < 0       # padding: no visible key, seen by no query
    assert (dq[dead] == 0).all() and (dk[dead] == 0).all() \
        and (dv[dead] == 0).all()


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 256])
def test_backward_kernel_row_whose_keys_are_all_padding(cuda, d):
    # row 1 is all padding (segment -1 everywhere): its dq, dk and dv are 0;
    # row 0 has a sample that ends mid-tile, then padding
    q, k, v, _, _ = _inputs(cuda, 2, 200, 200, 4, 2, d)
    seg = torch.full((2, 200), -1, dtype=torch.int32, device=cuda)
    seg[0, :150] = 0
    pos = torch.zeros_like(seg)
    pos[0, :150] = torch.arange(150, device=cuda)
    o, lse = fa.mha_forward(q, k, v, pos, pos, seg, seg, causal=True)
    do = torch.randn_like(o)
    ops.reset_launch_counts()
    dq, dk, dv = fa.mha_backward(q, k, v, pos, pos, seg, seg, o, lse, do,
                                 causal=True)
    assert ops.launch_counts()["mha_backward"] == 1
    ref = fa.mha_backward_plain(q, k, v, pos, pos, seg, seg, o, lse, do,
                                causal=True)
    for a, r in zip((dq, dk, dv), ref):
        _grad_close(a, r)
    dead = seg < 0
    assert (dq[dead] == 0).all() and (dk[dead] == 0).all() \
        and (dv[dead] == 0).all()
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()


def _segments(dev, b, t, lengths):
    """Rows of samples then padding (segment -1), positions restarting at 0."""
    seg = torch.full((b, t), -1, dtype=torch.int32, device=dev)
    pos = torch.zeros_like(seg)
    for row, lens in enumerate(lengths):
        at = 0
        for i, n in enumerate(lens):
            seg[row, at:at + n] = i
            pos[row, at:at + n] = torch.arange(n, device=dev)
            at += n
    return pos, seg


# name: (t, h, kv, samples per row or None for plain causal positions)
REPEAT_CASES = {
    "causal": (320, 4, 4, None),
    "causal-gqa4": (320, 8, 2, None),
    "segmented-gqa4": (320, 8, 2, [[150, 100], [200]]),
    # row 0's query tile 192..255 is padding: no live key tile at all
    "dead-query-tile": (384, 8, 2, [[190], [300, 60]]),
}


# head dim: (options, seed, cases). At 80, hubert's head dim: q, k, v, o
# and do padded with zero columns to 128, the kernels run at 128 with the
# scale of 80, and the results cut back to 80 columns. At 256, gemma2-2b's
# head dim and softcap, with a GQA group of 2 where the case has one of 4
# or more
REPEAT_FORMS = {
    128: (dict(causal=True), 3, sorted(REPEAT_CASES)),
    80: (dict(causal=False), 5, ["causal", "segmented-gqa4"]),
    256: (dict(causal=True, softcap=50.0), 7, sorted(REPEAT_CASES)),
}


@pytest.mark.parametrize("d,case", [(d, case) for d, (_, _, cases)
                                    in REPEAT_FORMS.items() for case in cases])
def test_backward_kernel_is_repeatable_bit_for_bit(cuda, d, case):
    # dq's tiles are added in ascending key tile, so two calls agree to the
    # bit, as dk and dv do
    opts, seed, _ = REPEAT_FORMS[d]
    t, h, kv, lengths = REPEAT_CASES[case]
    if d == 256:
        kv = max(kv, h // 2)
    q, k, v, qp, kp = _inputs(cuda, 2, t, t, h, kv, d, seed=seed)
    qs = ks = None
    if lengths is not None:
        qp, qs = _segments(cuda, 2, t, lengths)
        kp, ks = qp, qs
    o, lse = fa.mha_forward(q, k, v, qp, kp, qs, ks, **opts)
    assert o.shape == q.shape and o.is_contiguous()
    do = torch.randn_like(o)
    ops.reset_launch_counts()
    first = fa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do, **opts)
    assert ops.launch_counts()["mha_backward"] == 1
    for _ in range(3):
        again = fa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do, **opts)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), f"{case}: {name} differs between calls"
    ref = fa.mha_backward_plain(q, k, v, qp, kp, qs, ks, o, lse, do, **opts)
    for a, r in zip(first, ref):
        assert a.shape == r.shape
        _grad_close(a, r)
    if lengths is not None:     # padding: no query sees it, it sees no key
        dead = qs < 0
        assert all((g[dead] == 0).all() for g in first)


def test_shared_memory_of_the_kernel_forms(cuda):
    # the wgmma forms' plans at D <= 128 are unchanged; at D 256 K1's
    # prefill takes 64-key tiles and the backward has its own form, each
    # under the 232448 bytes a block may have
    from repro_torch.kernels import _build
    fwd = _build.library("flash_fwd").mha_fwd_prefill_smem
    bwd = _build.library("flash_bwd").mha_bwd_smem
    assert {d: fwd(d) for d in fa.HEAD_DIMS} == {
        16: 31832, 32: 52312, 64: 93272, 128: 175192, 256: 206936}
    assert {d: bwd(d) for d in fa.HEAD_DIMS} == {
        16: 52360, 32: 76936, 64: 126088, 128: 224392, 256: 231608}
    assert fwd(80) == bwd(80) == fwd(512) == bwd(512) == 0
    # the decode form: one row tile, and the most a block takes (64 rows, 32
    # at D 256), each near 110 KB or under at one row tile, so that two
    # blocks fit on an SM
    dec = _build.library("flash_fwd").mha_fwd_decode_smem
    assert {d: dec(d, 16) for d in fa.HEAD_DIMS} == {
        16: 22528, 32: 34816, 64: 59392, 128: 108544, 256: 103680}
    assert {d: dec(d, 64 if d <= 128 else 32) for d in fa.HEAD_DIMS} == {
        16: 30208, 32: 42496, 64: 67072, 128: 133632, 256: 122112}
    assert dec(256, 33) == dec(128, 65) == dec(80, 1) == 0


# gemma2-2b's attention options (softcap 50, a GQA group of 2) at head dim
# 256, where K1's prefill takes 64-key tiles and the backward its own form.
# name: (b, t, s, h, kv, samples per row or None, window, first query position)
D256_CASES = {
    # a sliding window that acts: query rows see at most 256 keys
    "window": (2, 1024, 1024, 4, 2, None, 256, 0),
    # rows of samples, then padding, at a T that is no multiple of 64
    "segmented-ragged": (2, 333, 333, 4, 2, [[150, 120], [200]], 0, 0),
    # 40960 keys: K1's walk over its table of key-tile statistics, which
    # holds 512 tiles of 64 keys, goes in two chunks; the queries are the
    # last 256 positions, so both chunks hold live tiles
    "keys-40960": (1, 256, 40960, 2, 1, None, 0, 40704),
}


@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_d256_kernels_at_gemma2_options_match_plain_versions(cuda, case):
    b, t, s, h, kv, lengths, window, q_first = D256_CASES[case]
    opts = dict(causal=True, window=window, softcap=50.0)
    q, k, v, qp, kp = _inputs(cuda, b, t, s, h, kv, 256, seed=11)
    qs = ks = None
    if lengths is not None:
        qp, qs = _segments(cuda, b, t, lengths)
        kp, ks = qp, qs
    qp = qp + q_first
    ops.reset_launch_counts()
    o, lse = fa.mha_forward(q, k, v, qp, kp, qs, ks, **opts)
    assert ops.launch_counts()["mha_forward"] == 1
    o_ref, lse_ref = fa.mha_forward_plain(q, k, v, qp, kp, qs, ks, **opts)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=TOL)
    do = torch.randn_like(o)
    first = fa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do, **opts)
    assert ops.launch_counts()["mha_backward"] == 1
    ref = fa.mha_backward_plain(q, k, v, qp, kp, qs, ks, o, lse, do, **opts)
    for a, r in zip(first, ref):
        assert a.shape == r.shape
        _grad_close(a, r)
    again = fa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do, **opts)
    for name, a, r in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, r), f"{case}: {name} differs between calls"
    if lengths is not None:     # padding: no query sees it, it sees no key
        dead = qs < 0
        assert (o[dead] == 0).all()
        assert all((g[dead] == 0).all() for g in first)


@pytest.mark.parametrize("t_acc", [64, 192])   # T 100 needs 128 rows
def test_backward_kernel_refuses_an_accumulator_of_another_length(cuda,
                                                                 t_acc):
    # the kernel's own query tile decides the padded length; a buffer cut
    # short or padded otherwise is refused before anything is launched
    q, k, v, qp, kp = _inputs(cuda, 1, 100, 100, 2, 2, 64)
    o, lse = fa.mha_forward(q, k, v, qp, kp, causal=True)
    do = torch.randn_like(o)
    acc = torch.zeros((1, 2, t_acc, 64), dtype=torch.float32, device=cuda)
    before = ops.launch_counts()["mha_backward"]
    with pytest.raises(RuntimeError, match="launch failed"):
        fa._launch_backward(q, k, v, qp, kp, None, None, o, lse, do,
                            fa.attention_delta(o, do), acc,
                            torch.empty_like(k), torch.empty_like(v),
                            causal=True, window=0, softcap=None,
                            sm_scale=fa.softmax_scale(64))
    torch.cuda.synchronize()
    assert not acc.any()
    assert ops.launch_counts()["mha_backward"] == before


def test_backward_kernel_refuses_more_keys_than_its_table(cuda):
    # S past BWD_MAX_KEYS: the wrapper raises before any launch, and the C
    # entry, reached past the wrapper's check, refuses to launch
    s = fa.BWD_MAX_KEYS + 1
    q, k, v, qp, kp = _inputs(cuda, 1, 64, s, 2, 2, 16)
    o, lse = fa.mha_forward(q, k, v, qp, kp, causal=False)
    do = torch.randn_like(o)
    delta = fa.attention_delta(o, do)
    before = ops.launch_counts()["mha_backward"]
    with pytest.raises(ValueError, match="at most 65536 keys"):
        fa.mha_backward_cuda(q, k, v, qp, kp, None, None, o, lse, do, delta,
                             causal=False, window=0, softcap=None)
    acc, sem = fa.dq_accumulator(q)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa._launch_backward(q, k, v, qp, kp, None, None, o, lse, do, delta,
                            acc, torch.empty_like(k), torch.empty_like(v),
                            causal=False, window=0, softcap=None,
                            sm_scale=fa.softmax_scale(16), sem=sem)
    torch.cuda.synchronize()
    assert not acc.any()
    assert ops.launch_counts()["mha_backward"] == before


def test_autograd_through_the_kernels_matches_the_cpu(cuda):
    q, k, v, qp, kp = _inputs(cuda, 2, 100, 100, 4, 2, 64)
    seg = torch.zeros_like(qp)
    seg[1, 60:] = -1
    ct = torch.randn(q.shape, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).detach().requires_grad_() for x in (q, k, v)]
        ops.reset_launch_counts()
        out = ops.attention(*leaves, q_positions=qp.to(dev),
                            kv_positions=kp.to(dev), q_segment_ids=seg.to(dev),
                            kv_segment_ids=seg.to(dev))
        (out.float() * ct.to(dev)).sum().backward()
        n = 1 if dev.type == "cuda" else 0
        assert ops.launch_counts() == {"mha_forward": n, "mha_backward": n,
                                       "ssd_chunked": 0, "ssd_backward": 0}
        grads.append([x.grad.cpu() for x in leaves])
    for a, r in zip(*grads):
        _grad_close(a, r)


def test_grad_step_on_the_card_matches_the_cpu_and_counts_launches(cuda):
    from repro_torch.train.pipeline_adapter import build_grad_step
    cfg = SV.make_config("gpt-paper", "reduced", 2)
    params = MD.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    r = np.random.default_rng(0)
    seg = np.zeros((2, 96), np.int32)
    seg[1, 50:] = -1
    pos = np.where(seg >= 0, np.arange(96), 0).astype(np.int32)
    batch = {"tokens": r.integers(0, cfg.vocab, (2, 96)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab, (2, 96)).astype(np.int32),
             "loss_weights": (seg >= 0).astype(np.float32),
             "positions": pos, "segment_ids": seg}
    step = build_grad_step(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    l_cpu, w_cpu, g_cpu = step(params, tb)
    ops.reset_launch_counts()
    l_gpu, w_gpu, g_gpu = step(_to(params, cuda), _to(tb, cuda))
    # forward, the recompute of each period, and one backward per layer
    assert ops.launch_counts() == {"mha_forward": 2 * cfg.n_layers,
                                   "mha_backward": cfg.n_layers,
                                   "ssd_chunked": 0, "ssd_backward": 0}
    assert float(w_gpu) == float(w_cpu)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, atol=GRAD_TOL, rtol=GRAD_TOL)

    def leaves(tree):
        if isinstance(tree, dict):
            for key in sorted(tree):
                yield from leaves(tree[key])
        else:
            yield tree
    for a, b in zip(leaves(g_gpu), leaves(g_cpu)):
        _grad_close(a.cpu(), b)


def test_runner_trajectory_on_the_card_is_repeatable_bit_for_bit(cuda):
    # two 2-iteration runs of the 2-layer runner from one seed: equal
    # losses, grad norms and parameters to the bit (the backward's dq, the
    # embedding gradient, the loss and AdamW all sum in a fixed order)
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    cfg = SV.make_config("gpt-paper", "reduced", 2)
    runs = []
    for _ in range(2):
        stream = MultiTaskStream(StreamConfig(
            n_tasks=8, global_tokens=1024, max_len=128, vocab=cfg.vocab,
            tail_fraction=0.1, tail_alpha=1.2, seed=0))
        pal = ShapePalette.build(min_seq=32, max_seq=128, seq_align=32,
                                 max_mbs=8)
        pcfg = PlannerConfig(n_stages=1, d_model=cfg.d_model, palette=pal)
        rcfg = RunnerConfig(n_iters=2, use_executor=False, log_every=0,
                            seed=0, device="cuda")
        ops.reset_launch_counts()
        params, hist, _ = PlanAheadRunner(
            cfg, AnalyticCostModel(cfg, n_stages=1), pcfg, rcfg,
            stream).run()
        assert ops.launch_counts()["mha_backward"] > 0
        runs.append((params, hist))
    (p0, h0), (p1, h1) = runs
    for a, b in zip(h0, h1):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    from repro_torch.tree import leaves
    for a, b in zip(leaves(p0), leaves(p1)):
        assert torch.equal(a, b)


def _t5_segments(dev, b, t, s, enc_lens):
    """The t5 slice's attention layouts: the encoder's rows, one sample of
    enc_lens[r] tokens each, then padding; the decoder's rows of a quarter
    of that, odd rows packed as two samples on both sides (segments 0 and
    1), the last row all padding. Returns (dec, enc) segment ids."""
    dec = torch.full((b, t), -1, dtype=torch.int32)
    enc = torch.full((b, s), -1, dtype=torch.int32)
    for r, n in enumerate(enc_lens):
        m = 0 if r == b - 1 else min(t, max(2, n // 4))
        n = 0 if r == b - 1 else n
        for side, length in ((enc, n), (dec, m)):
            side[r, :length] = 0
            if r % 2:
                side[r, length // 2:length] = 1
    return dec.to(dev), enc.to(dev)


@pytest.mark.parametrize("case", ["t5-enc", "t5-cross"])
def test_kernels_at_the_t5_shapes_match_plain_versions(cuda, case):
    # the t5 phase's attention at 128 heads x 128 and T = 512 (encoder
    # self-attention, non-causal) or T 128 to S 512 (cross-attention), on
    # four rows: K1 and the backward against their plain versions
    t = 512 if case == "t5-enc" else 128
    q, k, v, qp, kp = _inputs(cuda, 4, t, 512, 128, 128, 128)
    dec, enc = _t5_segments(cuda, 4, t, 512, (512, 400, 200, 64))
    qs = enc if case == "t5-enc" else dec
    args = (q, k, v, qp, kp, qs, enc)
    o, lse = fa.mha_forward(*args, causal=False)
    o_ref, lse_ref = fa.mha_forward_plain(*args, causal=False)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    seen = lse_ref > -1e29
    torch.testing.assert_close(lse[seen], lse_ref[seen], atol=TOL, rtol=TOL)
    assert (o[~seen.permute(0, 2, 1)] == 0).all()
    do = torch.randn_like(o)
    out = fa.mha_backward(*args, o, lse, do, causal=False)
    ref = fa.mha_backward_plain(*args, o, lse, do, causal=False)
    for a, r in zip(out, ref):
        _grad_close(a, r)


def _pipeline_runs(cuda, n_runs, n_stages=2):
    """``n_runs`` 2-iteration runs of the reduced gpt-paper (4 layers) on
    the threaded pipeline from one seed: (params, history, launch counts)."""
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    cfg = SV.make_config("gpt-paper", "reduced", 4)
    runs = []
    for _ in range(n_runs):
        stream = MultiTaskStream(StreamConfig(
            n_tasks=8, global_tokens=1024, max_len=128, vocab=cfg.vocab,
            tail_fraction=0.1, tail_alpha=1.2, seed=0))
        pal = ShapePalette.build(min_seq=32, max_seq=128, seq_align=32,
                                 max_mbs=4)
        pcfg = PlannerConfig(n_stages=n_stages, d_model=cfg.d_model,
                             palette=pal)
        rcfg = RunnerConfig(n_iters=2, log_every=0, seed=0, device="cuda")
        ops.reset_launch_counts()
        params, hist, stats = PlanAheadRunner(
            cfg, AnalyticCostModel(cfg, n_stages=n_stages), pcfg, rcfg,
            stream).run()
        assert stats.faults == 0
        n_micro = sum(h["n_micro"] for h in hist)
        assert ops.launch_counts() == {"mha_forward": 3 * 4 * n_micro,
                                       "mha_backward": 4 * n_micro,
                                       "ssd_chunked": 0, "ssd_backward": 0}
        runs.append((params, hist))
    return runs


def test_pipelined_step_on_the_card_matches_the_sequential_step(cuda):
    # one plan of the reduced gpt-paper over 2 stages, each on its own CUDA
    # stream, against the sequential grad steps over the same micro-batches
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig, plan_iteration
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.data.dataset import materialize_micro_batch
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    from repro_torch.dist.backend import ThreadsBackend
    from repro_torch.tree import flatten
    cfg = SV.make_config("gpt-paper", "reduced", 4)
    gb = MultiTaskStream(StreamConfig(n_tasks=8, global_tokens=1024,
                                      max_len=128, vocab=cfg.vocab,
                                      seed=0)).batch(0)
    pcfg = PlannerConfig(n_stages=2, d_model=cfg.d_model,
                         palette=ShapePalette.build(min_seq=32, max_seq=128,
                                                    seq_align=32, max_mbs=4))
    plan = plan_iteration(gb.lengths[:, 0], AnalyticCostModel(cfg, n_stages=2),
                          pcfg).replica_plans[0]
    assert len(plan.micro_batches) >= 2
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens,
                                                lengths=gb.lengths)
               for m in plan.micro_batches}
    params = MD.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    pipe = ThreadsBackend(cfg, 2, device=cuda)
    assert pipe.pm is not None
    res = pipe.execute_plan(plan, params=params, batches=batches)
    assert len(pipe.pm.streams) == 2
    seq = ThreadsBackend(cfg, 2, use_executor=False, device=cuda)
    sres = seq.execute_plan(plan, params=params, batches=batches)
    assert res.weight_sum == sres.weight_sum
    np.testing.assert_allclose(res.loss_sum / res.weight_sum,
                               sres.loss_sum / sres.weight_sum, rtol=1e-4)
    ref = dict(flatten(sres.grads))
    for key, g in flatten(res.grads):
        _grad_close(g, ref[key])


def test_pipelined_runs_on_the_card_are_repeatable_bit_for_bit(cuda):
    (p0, h0), (p1, h1) = _pipeline_runs(cuda, 2)
    for a, b in zip(h0, h1):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    from repro_torch.tree import leaves
    for a, b in zip(leaves(p0), leaves(p1)):
        assert torch.equal(a, b)


def _mesh_setup(n_stages=2):
    """The reduced gpt-paper (4 layers), its planner and stream, and a
    stage mesh of ``n_stages`` on the one card."""
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    from repro_torch.launch.mesh import make_stage_mesh
    cfg = SV.make_config("gpt-paper", "reduced", 4)
    stream = MultiTaskStream(StreamConfig(
        n_tasks=8, global_tokens=1024, max_len=128, vocab=cfg.vocab,
        tail_fraction=0.1, tail_alpha=1.2, seed=0))
    pcfg = PlannerConfig(n_stages=n_stages, d_model=cfg.d_model,
                         palette=ShapePalette.build(min_seq=32, max_seq=128,
                                                    seq_align=32, max_mbs=4))
    mesh = make_stage_mesh(n_stages, devices=["cuda:0"] * n_stages)
    return cfg, stream, AnalyticCostModel(cfg, n_stages=n_stages), pcfg, mesh


def test_mesh_step_on_the_card_matches_the_threads_backend(cuda):
    # one plan over a 2-stage mesh on the card, against the threads
    # backend's sequential grad steps on the same micro-batches; 3 K1 and
    # 1 backward launch per layer and micro-batch, as the pipeline
    from repro_torch.core.planner import plan_iteration
    from repro_torch.data.dataset import materialize_micro_batch
    from repro_torch.dist.backend import MeshBackend, ThreadsBackend
    from repro_torch.tree import flatten
    cfg, stream, cost, pcfg, mesh = _mesh_setup()
    gb = stream.batch(0)
    plan = plan_iteration(gb.lengths[:, 0], cost, pcfg).replica_plans[0]
    assert len(plan.micro_batches) >= 2
    batches = {m.mb_id: materialize_micro_batch(m, gb.tokens,
                                                lengths=gb.lengths)
               for m in plan.micro_batches}
    params = MD.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    ops.reset_launch_counts()
    res = MeshBackend(cfg, 2, mesh=mesh).execute_plan(plan, params=params,
                                                      batches=batches)
    n = len(plan.micro_batches)
    assert ops.launch_counts() == {"mha_forward": 3 * 4 * n,
                                   "mha_backward": 4 * n, "ssd_chunked": 0,
                                   "ssd_backward": 0}
    sres = ThreadsBackend(cfg, 2, use_executor=False, device=cuda
                          ).execute_plan(plan, params=params, batches=batches)
    assert res.weight_sum == sres.weight_sum
    np.testing.assert_allclose(res.loss_sum / res.weight_sum,
                               sres.loss_sum / sres.weight_sum, rtol=1e-4)
    ref = dict(flatten(sres.grads))
    for key, g in flatten(res.grads):
        assert g.is_cuda, key
        _grad_close(g, ref[key])


def test_mesh_runs_on_the_card_are_repeatable_bit_for_bit(cuda):
    from repro_torch.dist.sharding import ZeroShards
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    from repro_torch.tree import leaves
    runs = []
    for _ in range(2):
        cfg, stream, cost, pcfg, mesh = _mesh_setup()
        runner = PlanAheadRunner(
            cfg, cost, pcfg, RunnerConfig(n_iters=2, log_every=0, seed=0,
                                          backend="mesh", device="cuda"),
            stream, mesh=mesh)
        params, hist, stats = runner.run()
        assert stats.faults == 0
        assert all(isinstance(x, ZeroShards)
                   for x in leaves(runner.opt_state["m"]))
        runs.append((params, hist))
    (p0, h0), (p1, h1) = runs
    assert [(h["loss"], h["grad_norm"]) for h in h0] == \
        [(h["loss"], h["grad_norm"]) for h in h1]
    for a, b in zip(leaves(p0), leaves(p1)):
        assert torch.equal(a, b)


def test_zero1_update_on_the_card_equals_adamw_to_the_bit(cuda):
    from repro_torch.dist.backend import MeshBackend
    from repro_torch.train import optimizer as TO
    from repro_torch.tree import leaves, tree_map
    cfg, _, _, _, mesh = _mesh_setup(4)
    params = MD.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=cuda).to(p.dtype), params)
    ocfg = TO.AdamWConfig(lr=1e-2)
    opt = TO.init_opt_state(params, ocfg)
    backend = MeshBackend(cfg, 4, mesh=mesh)
    placed = backend.place_opt_state(
        tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, opt))
    p_ref = tree_map(torch.clone, params)
    for _ in range(2):
        p_ref, opt, _ = TO.adamw_update(p_ref, grads, opt, ocfg)
        params, placed, _ = backend.optimizer_step(params, grads, placed, ocfg)
    for a, b in zip(leaves(p_ref), leaves(params)):
        assert torch.equal(a, b)
    for key in ("master", "m", "v"):
        for a, b in zip(leaves(opt[key]), leaves(placed[key])):
            assert torch.equal(a, b.whole(cuda)), key


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_serve_on_the_card_matches_the_cpu_and_counts_launches(cuda):
    cfg = SV.make_config("gpt-paper", "reduced", 2)
    params = MD.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = SV.make_requests(cfg, 8, 128)
    ops.reset_launch_counts()
    on_cpu = SV.serve(params, cfg, tokens, max_prompt=128, decode_steps=3)
    assert ops.launch_counts()["mha_forward"] == 0
    params_gpu = _to(params, cuda)
    on_gpu = SV.serve(params_gpu, cfg, tokens, max_prompt=128, decode_steps=3)
    nb = len(on_gpu.batches)
    assert ops.launch_counts()["mha_forward"] == cfg.n_layers * nb * (1 + 3)
    for a, b in zip(on_gpu.logits, on_cpu.logits):
        a, b = a.cpu().float()[0], b.float()[0]     # prefill logits
        err = float((a - b).abs().max()) / (1 + float(b.abs().max()))
        assert err <= TOL
    assert all(np.isfinite(t).all() for t in on_gpu.tokens)


def _ssd_inputs(dev, b, t, h, p, g, n, seed=0, a_scale=1.0):
    """x, B, C as strided views of one (B, T, H·P + 2·G·N) bf16 tensor, as
    mamba_fwd passes them; dt and A fp32 (A times ``a_scale``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((b, t, h * p + 2 * g * n), generator=gen, device=dev
                    ).to(torch.bfloat16)
    x = u[..., :h * p].reshape(b, t, h, p)
    B = u[..., h * p:h * p + g * n].reshape(b, t, g, n)
    C = u[..., h * p + g * n:].reshape(b, t, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, h), generator=gen, device=dev))
    A = -torch.exp(torch.randn((h,), generator=gen, device=dev)) * a_scale
    return x, dt, A, B, C


SSD_CASES = [   # b, t, h, p, g, n, a_scale
    (2, 1, 4, 16, 2, 16, 1.0),        # one step, two groups
    (2, 96, 4, 16, 2, 16, 1.0),       # under two chunks, two groups
    (2, 192, 24, 64, 1, 128, 1.0),    # three chunks, mamba2-130m's heads
    (2, 192, 4, 16, 2, 16, 1.0),
    (1, 300, 8, 32, 4, 32, 1.0),      # ragged, four groups
    (2, 300, 4, 16, 2, 16, 1.0),
    (2, 300, 4, 64, 2, 128, 40.0),    # a decay past -60 within a chunk
    (1, 200, 4, 128, 1, 64, 1.0),     # the widest head K4 takes
]


@pytest.mark.parametrize("b,t,h,p,g,n,a_scale", SSD_CASES)
def test_ssd_kernel_matches_plain_version(cuda, b, t, h, p, g, n, a_scale):
    x, dt, A, B, C = _ssd_inputs(cuda, b, t, h, p, g, n, a_scale=a_scale)
    assert not x.is_contiguous()
    ops.reset_launch_counts()
    y, st, starts = SSD._ssd_cuda(x, dt, A, B, C, chunk_states=True)
    assert ops.launch_counts()["ssd_chunked"] == 1
    y_ref, st_ref = tref.ssd_ref_chunked(x, dt, A, B, C)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    torch.testing.assert_close(st, st_ref, atol=SSD_TOL, rtol=SSD_TOL)
    # the state's recurrence alone: K4's chunk-start states against the
    # plain pass over chunks
    _, st_cp, starts_cp = tref.ssd_chunk_parallel(x, dt, A, B, C)
    assert starts.shape == starts_cp.shape
    torch.testing.assert_close(starts.float(), starts_cp, atol=SSD_TOL,
                               rtol=SSD_TOL)
    torch.testing.assert_close(st, st_cp, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("b,t,h,p,g,n,a_scale", SSD_CASES[1:3])
def test_ssd_kernel_is_repeatable_bit_for_bit(cuda, b, t, h, p, g, n,
                                              a_scale):
    args = _ssd_inputs(cuda, b, t, h, p, g, n, a_scale=a_scale)
    y, st = SSD.ssd_chunked(*args)
    for _ in range(3):
        y2, st2 = SSD.ssd_chunked(*args)
        assert torch.equal(y, y2) and torch.equal(st, st2)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 8, 2, 16, 1, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.ssd(x.float(), dt, A, B, C)
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssd(x, dt, A, B, C, initial_state=torch.zeros((1, 2, 16, 16)))
    # the backward takes head dim 128 with state 128 (jamba's mixer), and
    # refuses with a message a head dim past the card's limits
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 8, 1, 128, 1, 128)
    A = A.clone().requires_grad_()
    ops.reset_launch_counts()
    ops.ssd(x, dt, A, B, C).float().sum().backward()
    assert ops.launch_counts()["ssd_backward"] == 1
    assert bool(torch.isfinite(A.grad).all())
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 8, 1, 144, 1, 128)
    starts = torch.empty((1, 1, 0, 2, 144, 128), dtype=torch.bfloat16,
                         device=cuda)
    with pytest.raises(ValueError, match="multiples of 16 up to 128"):
        SSD._ssd_bwd_cuda(x, dt, A, B, C, torch.zeros_like(x), starts)


SSD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_initial")


def _per_chunk_rel(out, ref, chunk=64):
    """Worst ||out - ref|| / ||ref|| over (batch row, 64-step chunk, head
    or group) of a (B, T, H) or (B, T, H, X) gradient."""
    o, r = out.float(), ref.float()
    b, t = o.shape[:2]
    nc = -(-t // chunk)
    pad = (0, 0) * (o.dim() - 2) + (0, nc * chunk - t)
    o = torch.nn.functional.pad(o, pad).reshape(b, nc, chunk, *o.shape[2:])
    r = torch.nn.functional.pad(r, pad).reshape(b, nc, chunk, *r.shape[2:])
    dims = (2,) if o.dim() == 4 else (2, 4)
    d = (o - r).norm(dim=dims)
    rn = r.norm(dim=dims)
    return float(torch.where(rn > 0, d / rn.clamp_min(1e-30),
                             torch.where(d > 0, float("inf"), 0.0)).max())


def _whole_rel(out, ref):
    out, ref = out.detach().float(), ref.detach().float()
    return float((out - ref).norm() / ref.norm().clamp_min(1e-30))


def _ssd_bwd_both(args, dy, d_final=None, init=None):
    """K4's backward on K4's own chunk-start states, and the plain walk on
    the plain pass's, from the same dy, d_final and initial state."""
    x, dt, A, B, C = args
    _, _, raw = SSD._ssd_launch(x, dt, A, B, C, init, True)
    got = SSD._ssd_bwd_cuda(x, dt, A, B, C, dy, raw, d_final, init)
    starts = tref.ssd_chunk_parallel(x, dt, A, B, C, initial_state=init)[2]
    want = tref.ssd_chunked_bwd(x, dt, A, B, C, dy, starts, d_final=d_final,
                                initial_state=init)
    return got, want


SSD_BWD_CASES = [   # b, t, h, p, g, n, a_scale
    (2, 192, 24, 64, 1, 128, 1.0),    # mamba2-130m's heads, three chunks
    (2, 300, 4, 16, 2, 16, 1.0),      # G < H, ragged
    (1, 300, 8, 32, 4, 32, 1.0),      # four groups
    (2, 300, 4, 64, 2, 128, 40.0),    # a decay past -60 within a chunk
    (2, 1, 4, 16, 2, 16, 1.0),        # one step
    (1, 130, 4, 128, 1, 64, 1.0),     # the widest head, at N 64
    (2, 300, 4, 128, 1, 128, 1.0),    # jamba's head and state: P 128, N 128
]


@pytest.mark.parametrize("b,t,h,p,g,n,a_scale", SSD_BWD_CASES)
def test_ssd_backward_matches_the_plain_walk_per_chunk(cuda, b, t, h, p, g,
                                                       n, a_scale):
    # per 64-step chunk for dx, ddt, dB and dC, whole for dA and d_initial:
    # within 1e-2 by norm (the outputs are rounded to bf16, and every fp32
    # operand of a product keeps about 16 bits as hi and lo)
    args = _ssd_inputs(cuda, b, t, h, p, g, n, a_scale=a_scale)
    gen = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn((b, t, h, p), generator=gen, device=cuda
                     ).to(torch.bfloat16)
    d_final = torch.randn((b, h, p, n), generator=gen, device=cuda)
    ops.reset_launch_counts()
    got, want = _ssd_bwd_both(args, dy, d_final)
    assert ops.launch_counts()["ssd_backward"] == 1
    torch.cuda.synchronize()
    for name, o, w in zip(SSD_NAMES, got, want):
        assert o.shape == w.shape and o.dtype == w.dtype, name
        assert bool(torch.isfinite(o).all()), name
        rel = (_whole_rel(o, w) if name in ("dA", "d_initial")
               else _per_chunk_rel(o, w))
        assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("b,t,h,p,g,n,a_scale",
                         SSD_BWD_CASES[:2] + SSD_BWD_CASES[-1:])
def test_ssd_backward_is_repeatable_bit_for_bit(cuda, b, t, h, p, g, n,
                                                a_scale):
    args = _ssd_inputs(cuda, b, t, h, p, g, n, a_scale=a_scale)
    dy = torch.randn((b, t, h, p), device=cuda).to(torch.bfloat16)
    _, _, raw = SSD._ssd_launch(*args, None, True)
    first = SSD._ssd_bwd_cuda(*args, dy, raw)
    for _ in range(2):
        again = SSD._ssd_bwd_cuda(*args, dy, raw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("b,t,h,p,g,n", [(2, 192, 24, 64, 1, 128),
                                         (2, 100, 4, 16, 2, 16)])
def test_ssd_from_an_initial_state_matches_the_oracle(cuda, b, t, h, p, g, n):
    # K4 from a given state (ROADMAP A17), values and gradients, against
    # autograd of the quadratic oracle ref.ssd_ref; the backward's
    # d_initial also against the plain walk
    x, dt, A, B, C = _ssd_inputs(cuda, b, t, h, p, g, n)
    s0 = torch.randn((b, h, p, n), device=cuda)
    dy = torch.randn((b, t, h, p), device=cuda).to(torch.bfloat16)
    d_final = torch.randn((b, h, p, n), device=cuda)
    ops.reset_launch_counts()
    y, st = ops.ssd(x, dt, A, B, C, initial_state=s0, return_state=True)
    assert ops.launch_counts()["ssd_chunked"] == 1
    y_ref, st_ref = tref.ssd_ref(x, dt, A, B, C, initial_state=s0,
                                 return_state=True)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    torch.testing.assert_close(st, st_ref, atol=SSD_TOL, rtol=SSD_TOL)
    y_cp, _, starts = tref.ssd_chunk_parallel(x, dt, A, B, C,
                                              initial_state=s0)
    _, _, starts_k4 = SSD._ssd_cuda(x, dt, A, B, C, chunk_states=True,
                                    initial_state=s0)
    torch.testing.assert_close(starts_k4, starts, atol=SSD_TOL, rtol=SSD_TOL)
    got, want = _ssd_bwd_both((x, dt, A, B, C), dy, d_final, s0)
    assert _whole_rel(got[5], want[5]) <= 1e-2
    # gradients through autograd on the card against the oracle's
    ins = [v.clone().requires_grad_() for v in (x, dt, A, B, C, s0)]
    ref_ins = [v.detach().clone().requires_grad_() for v in ins]
    y, st = ops.ssd(*ins[:5], initial_state=ins[5], return_state=True)
    g_card = torch.autograd.grad(
        (y.float() * dy.float()).sum() + (st * d_final).sum(), ins)
    y, st = tref.ssd_ref(*ref_ins[:5], initial_state=ref_ins[5],
                         return_state=True)
    g_ref = torch.autograd.grad(
        (y.float() * dy.float()).sum() + (st * d_final).sum(), ref_ins)
    for name, a, r in zip(SSD_NAMES, g_card, g_ref):
        assert _whole_rel(a, r) <= 1e-2, (name, _whole_rel(a, r))


def test_mamba_mixer_gradients_on_the_card_match_the_cpu(cuda):
    # one mixer's mamba_fwd in train mode, bf16, its input and every
    # parameter's gradient from the same cotangent: K4 and its backward on
    # the card, autograd of the plain SSD on the CPU; within 2e-2 by norm
    # per leaf (the matmuls and the SSD round to bf16 at other points)
    import dataclasses
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import mamba as TMB
    cfg = dataclasses.replace(reduced(get_arch("mamba2-130m")),
                              dtype="bfloat16")
    params = TMB.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 200, cfg.d_model), generator=g).to(torch.bfloat16)
    ct = torch.randn(x.shape, generator=g)

    def run(dev):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xd = x.to(dev).requires_grad_()
        y, _ = TMB.mamba_fwd(p, xd, cfg)
        (y.float() * ct.to(dev)).sum().backward()
        return y, {"x": xd.grad, **{k: v.grad for k, v in p.items()}}
    ops.reset_launch_counts()
    y, grads = run(cuda)
    assert ops.launch_counts()["ssd_chunked"] == 1
    assert ops.launch_counts()["ssd_backward"] == 1
    yc, grads_c = run(torch.device("cpu"))
    assert _whole_rel(y.cpu(), yc) <= 2e-2
    for k, gc in grads_c.items():
        assert _whole_rel(grads[k].cpu(), gc) <= 2e-2, (k, _whole_rel(
            grads[k].cpu(), gc))


def test_jamba_period_gradients_on_the_card_match_the_cpu(cuda):
    # one reduced jamba period (mamba and attention mixers, MoE on odd
    # layers) through the grad step, the period checkpoint's recompute
    # included: K1, the attention backward, K4 twice and K4's backward per
    # mamba layer on the card; the CPU replays the card's expert routes
    # (a route may flip between devices where two probabilities tie).
    # Every gradient leaf within JAMBA_GRAD_TOL by norm, which a backward
    # planted to return a zero dx must exceed. This bf16 model's leaves
    # move far under rounding: one bf16 ulp on a tenth of the SSD's output
    # moves its D, A_log and dt_bias gradients (sums whose terms cancel) by
    # up to 7.4e-2 on the CPU; on an H100 80GB HBM3 (700 W) the plain SSD
    # read up to 2.8e-2 against the CPU, the kernels 4.1e-2
    import dataclasses
    from unittest import mock
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import layers as TL
    from repro_torch.train.pipeline_adapter import build_grad_step
    from repro_torch.tree import flatten
    cfg = dataclasses.replace(reduced(get_arch("jamba-1.5-large-398b")),
                              capacity_factor=16.0)
    params = MD.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    r = np.random.default_rng(0)
    b, s = 2, 64
    tok = r.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:]),
             "loss_weights": torch.ones((b, s)),
             "positions": torch.arange(s, dtype=torch.int32)[None]
             .expand(b, s).contiguous(),
             "segment_ids": torch.zeros((b, s), dtype=torch.int32)}
    step = build_grad_step(cfg)
    routes, real = [], TL.moe_route

    def record(xf, router, c):
        out = real(xf, router, c)
        routes.append(out[2].cpu())
        return out

    def replay(xf, router, c):
        probs, _, _ = real(xf, router, c)
        top_i = routes.pop(0).to(xf.device)
        top_p = probs.gather(1, top_i)
        return probs, top_p / top_p.sum(-1, keepdim=True), top_i
    ops.reset_launch_counts()
    with mock.patch.object(TL, "moe_route", record):
        loss, w, grads = step(_to(params, cuda), _to(batch, cuda))
    recorded = list(routes)
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_pattern) \
        * cfg.n_periods
    assert ops.launch_counts() == {
        "mha_forward": 2 * (cfg.n_layers - n_mamba),
        "mha_backward": cfg.n_layers - n_mamba,
        "ssd_chunked": 2 * n_mamba, "ssd_backward": n_mamba}
    with mock.patch.object(TL, "moe_route", replay):
        loss_c, _, grads_c = step(params, batch)
    assert not routes
    assert abs(float(loss) - float(loss_c)) <= TOL * abs(float(loss_c))
    gc = dict(flatten(grads_c))
    for k, v in flatten(grads):
        assert bool(torch.isfinite(v).all()), k
        assert _whole_rel(v.cpu(), gc[k]) <= JAMBA_GRAD_TOL, (
            k, _whole_rel(v.cpu(), gc[k]))
    real_bwd = SSD._ssd_bwd_cuda

    def zero_dx(*a, **o):
        dx, *rest = real_bwd(*a, **o)
        return (torch.zeros_like(dx), *rest)
    routes[:] = recorded
    with mock.patch.object(TL, "moe_route", replay), \
            mock.patch.object(SSD, "_ssd_bwd_cuda", zero_dx):
        _, _, grads_f = step(_to(params, cuda), _to(batch, cuda))
    assert max(_whole_rel(v.cpu(), gc[k]) for k, v in flatten(grads_f)) \
        > JAMBA_GRAD_TOL


def test_mamba_serve_on_the_card_matches_the_cpu_and_counts_launches(cuda):
    cfg = SV.make_config("mamba2-130m", "reduced", 2)
    params = MD.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = SV.make_requests(cfg, 8, 128)
    ops.reset_launch_counts()
    on_cpu = SV.serve(params, cfg, tokens, max_prompt=128, decode_steps=3)
    assert ops.launch_counts()["ssd_chunked"] == 0
    on_gpu = SV.serve(_to(params, cuda), cfg, tokens, max_prompt=128,
                      decode_steps=3)
    nb = len(on_gpu.batches)
    assert ops.launch_counts() == {"mha_forward": 0, "mha_backward": 0,
                                   "ssd_chunked": cfg.n_layers * nb,
                                   "ssd_backward": 0}
    for a, b in zip(on_gpu.logits, on_cpu.logits):
        a, b = a.cpu().float()[0], b.float()[0]     # prefill logits
        err = float((a - b).abs().max()) / (1 + float(b.abs().max()))
        assert err <= TOL


def test_checkpoint_save_and_restore_in_place_on_the_card(cuda, tmp_path):
    # a CUDA tree of bf16 params, fp32 master, m and v and the int step:
    # saved, scribbled over, restored in place, equal to the bit, every
    # tensor at its old address
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import optimizer as TO
    from repro_torch.tree import flatten, tree_map
    cfg = SV.make_config("gpt-paper", "reduced", 2)
    params = MD.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    opt = TO.init_opt_state(params, TO.AdamWConfig())
    grads = tree_map(torch.ones_like, params)
    params, opt, _ = TO.adamw_update(params, grads, opt, TO.AdamWConfig())
    state = {"params": params, "opt": opt}
    want = {p: x.clone() for p, x in flatten(state)
            if isinstance(x, torch.Tensor)}
    ptrs = {p: x.data_ptr() for p, x in flatten(state)
            if isinstance(x, torch.Tensor)}
    CKPT.save(tmp_path, 1, state)
    for _, x in flatten(state):
        if isinstance(x, torch.Tensor):
            x.fill_(7)
    state["opt"]["step"] = 0
    got, manifest = CKPT.load(tmp_path, state)
    assert manifest["step"] == 1 and got["opt"]["step"] == 1
    for p, x in flatten(got):
        if isinstance(x, torch.Tensor):
            assert x.is_cuda and x.data_ptr() == ptrs[p], p
            assert torch.equal(x, want[p]), p


def test_pipelined_fault_run_on_the_card_equals_the_fault_free_run(
        cuda, tmp_path):
    # 2 stages at reduced width: a state-losing crash on stage 1's backward
    # (stage 0 mid-plan on its own stream) restores step 2 and replays; a
    # crash on stage 0's forward retries in memory. Trajectory and final
    # parameters equal the fault-free run's to the bit. A straggler monitor
    # takes each replica's time, closed on a device synchronise.
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    from repro_torch.dist.chaos import (FaultEvent, FaultKind, FaultSchedule,
                                        LogicalClock)
    from repro_torch.dist.fault import StragglerMonitor
    from repro_torch.train.runner import PlanAheadRunner, RunnerConfig
    from repro_torch.tree import leaves
    cfg = SV.make_config("gpt-paper", "reduced", 2)
    monitors = []

    def run(chaos, ckpt_dir):
        monitors.append(StragglerMonitor(1, heartbeat_timeout=2.0,
                                         clock=LogicalClock()))
        stream = MultiTaskStream(StreamConfig(
            n_tasks=8, global_tokens=1024, max_len=128, vocab=cfg.vocab,
            tail_fraction=0.1, tail_alpha=1.2, seed=0))
        pcfg = PlannerConfig(n_stages=2, d_model=cfg.d_model,
                             palette=ShapePalette.build(
                                 min_seq=32, max_seq=128, seq_align=32,
                                 max_mbs=4))
        rcfg = RunnerConfig(n_iters=5, log_every=0, seed=0, device="cuda",
                            ckpt_dir=str(ckpt_dir), ckpt_every=2,
                            strict_verify=True, retry_backoff_s=0.01)
        return PlanAheadRunner(cfg, AnalyticCostModel(cfg, n_stages=2), pcfg,
                               rcfg, stream, chaos=chaos,
                               monitor=monitors[-1]).run()

    chaos = FaultSchedule([
        FaultEvent(3, FaultKind.STAGE_CRASH, stage=1, op="B", state_lost=True),
        FaultEvent(4, FaultKind.STAGE_CRASH, stage=0, op="F")])
    pf, hf, sf = run(chaos, tmp_path / "fault")
    p0, h0, _ = run(None, tmp_path / "free")
    assert not chaos.pending()
    assert [(r["kind"], r.get("restored_step")) for r in sf.recoveries] == \
        [("checkpoint_restore", 2), ("retry", None)]
    assert [h["iter"] for h in hf] == [0, 1, 2, 2, 3, 4]
    last = {h["iter"]: (h["loss"], h["grad_norm"]) for h in hf}
    assert last == {h["iter"]: (h["loss"], h["grad_norm"]) for h in h0}
    for a, b in zip(leaves(pf), leaves(p0)):
        assert torch.equal(a, b)
    assert all(m.mean_iter_time(0) > 0 for m in monitors)


def _moe_cfg():
    import dataclasses
    from repro_torch.configs.base import get_arch, reduced
    # reduced granite-moe at a width the kernels' callers see (d 256), 8
    # experts top-2 with a shared expert, capacity that drops some tokens
    return dataclasses.replace(reduced(get_arch("granite-moe-3b-a800m")),
                               d_model=256, n_experts=8, d_ff_expert=128,
                               n_shared_experts=1, capacity_factor=1.0)


def test_moe_layer_on_the_card_matches_the_cpu_and_repeats_bit_for_bit(cuda):
    # the dispatch copies each kept choice into its own slot and the gather
    # reads each once, so the forward and backward add nothing in an order
    # that varies: two calls agree to the bit
    from repro_torch.models import layers as TL
    from repro_torch.tree import flatten, tree_map
    cfg = _moe_cfg()
    params = TL.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 256, cfg.d_model), generator=g).to(torch.bfloat16)
    ct = torch.randn(x.shape, generator=g)

    def run(dev):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        xd = x.to(dev).requires_grad_()
        y, aux = TL.moe_fwd(p, xd, cfg)
        ((y.float() * ct.to(dev)).sum() + aux).backward()
        return y, aux, xd.grad, {k: v.grad for k, v in flatten(p)}
    y, aux, gx, gp = run(cuda)
    y2, aux2, gx2, gp2 = run(cuda)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert torch.equal(gx, gx2)
    assert all(torch.equal(gp[k], gp2[k]) for k in gp)
    yc, auxc, _, _ = run(torch.device("cpu"))
    torch.testing.assert_close(aux.cpu(), auxc, atol=1e-5, rtol=1e-5)
    # routes may flip between devices where two experts' probabilities
    # tie in the last bits; the rows whose routes agree are compared
    from repro_torch.models.layers import moe_route
    xf = x.reshape(-1, cfg.d_model)
    same = (moe_route(xf.to(cuda), params["router"].to(cuda), cfg)[2].cpu()
            == moe_route(xf, params["router"], cfg)[2]).all(-1)
    assert same.float().mean() > 0.99
    torch.testing.assert_close(y.float().cpu().reshape(-1, cfg.d_model)[same],
                               yc.float().reshape(-1, cfg.d_model)[same],
                               atol=TOL, rtol=TOL)


def test_jamba_period_on_the_card_matches_the_cpu(cuda):
    # one reduced jamba period (mamba and attention mixers, MoE on odd
    # layers) through K1, K4 and the MoE layer: forward, prefill and
    # decode (the gradients: the test below)
    import dataclasses
    from repro_torch.configs.base import get_arch, reduced
    cfg = dataclasses.replace(reduced(get_arch("jamba-1.5-large-398b")),
                              capacity_factor=16.0)
    params = MD.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    r = np.random.default_rng(0)
    b, s = 2, 64
    tok = torch.from_numpy(r.integers(0, cfg.vocab, (b, s + 1),
                                      dtype=np.int32))
    pos = torch.arange(s + 1, dtype=torch.int32)[None].expand(b, s + 1)
    full = {"tokens": tok, "positions": pos.contiguous()}
    pre = {"tokens": tok[:, :s], "positions": pos[:, :s].contiguous()}
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = _to(params, dev)
        ops.reset_launch_counts()
        with torch.no_grad():
            h, _, aux = MD.forward(p, _to(full, dev), cfg, remat=False)
            logits, cache = MD.prefill(p, _to(pre, dev), cfg,
                                       cache_len=s + 1)
            dec, _ = MD.decode(p, {
                "tokens": tok[:, -1:].to(dev),
                "positions": torch.full((b, 1), s, dtype=torch.int32,
                                        device=dev),
                "cache": cache, "cache_pos": s}, cfg)
        out[dev.type] = (MD._last_logits(p, h, cfg), logits, dec, aux)
        n = 1 if dev.type == "cuda" else 0
        # attention: forward, prefill, decode; mamba: forward and prefill
        assert ops.launch_counts() == {"mha_forward": 3 * n,
                                       "mha_backward": 0,
                                       "ssd_chunked": 2 * 7 * n,
                                       "ssd_backward": 0}
    for a, c in zip(out["cuda"], out["cpu"]):
        a, c = a.float().cpu(), c.float()
        err = float((a - c).abs().max()) / (1 + float(c.abs().max()))
        assert err <= TOL
    # decode against the full forward's last position, on the card
    got, want = out["cuda"][2], out["cuda"][0]
    err = float((got - want).abs().max()) / (1 + float(want.abs().max()))
    assert err <= TOL


def test_tree_wire_roundtrips_on_the_card(cuda):
    # the process fault domain's gradient format: a tree on the card goes
    # off it in one pinned buffer and comes back equal to the bit, on the
    # host and on the card; and the coordinator's host merge of bf16 trees
    # (tree.add_into) rounds as the in-process runner's merge on the card
    from repro_torch.dist.cluster import _tree_from_bytes, _tree_to_bytes
    from repro_torch.tree import add_into, flatten, tree_map
    g = torch.Generator(device=cuda).manual_seed(0)
    f32 = torch.randn(33, 7, generator=g, device=cuda)
    f32[0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
    scales = torch.logspace(-30, 30, 257, device=cuda)
    tree = {"w": (torch.randn(4096, 257, generator=g, device=cuda)
                  * scales).bfloat16(),
            "b": {"f": f32, "i": torch.arange(-9, 9, dtype=torch.int32,
                                              device=cuda)},
            "step": 3}
    blob = _tree_to_bytes(tree)
    for device in (None, cuda):
        back = _tree_from_bytes(blob, device)
        assert back["step"] == 3
        for (p, x), (_, y) in zip(flatten(tree), flatten(back)):
            if isinstance(x, torch.Tensor):
                assert y.device.type == ("cuda" if device else "cpu"), p
                assert y.dtype == x.dtype and y.shape == x.shape, p
                bits = x.view(torch.int16) if x.dtype == torch.bfloat16 \
                    else x.view(torch.int32)
                ybits = y.view(torch.int16) if y.dtype == torch.bfloat16 \
                    else y.view(torch.int32)
                assert torch.equal(ybits.cpu(), bits.cpu()), p
    other = {"w": (torch.randn(4096, 257, generator=g, device=cuda)
                   * scales.flip(0)).bfloat16()}
    on_card = add_into(tree_map(torch.clone, {"w": tree["w"]}), other)
    on_host = add_into(tree_map(lambda x: x.cpu(), {"w": tree["w"]}),
                       tree_map(lambda x: x.cpu(), other))
    assert torch.equal(on_host["w"].view(torch.int16),
                       on_card["w"].cpu().view(torch.int16))


# ----------------------------------------------------------------------
# the dry run against the card (ROADMAP A16), and the "dots" policy (A20)
# ----------------------------------------------------------------------
def _dryrun_cell(kind, policy="nothing", layers=2):
    """gpt-paper at full width and 2 layers; a train step or a prefill at
    B 2 x T 1024, a decode step against a 1040-position cache."""
    import dataclasses
    from repro_torch.configs.base import ShapeSpec, get_arch
    cfg = dataclasses.replace(get_arch("gpt-paper"), n_layers=layers,
                              remat_policy=policy)
    seq = 1040 if kind == "decode" else 1024
    return cfg, ShapeSpec(f"{kind}_{seq}", kind, seq, 2)


@pytest.mark.parametrize("kind,policy", [("train", "nothing"),
                                         ("train", "dots"),
                                         ("prefill", "nothing"),
                                         ("decode", "nothing")])
def test_dry_run_predicts_the_cards_peak_flops_and_launches(cuda, kind,
                                                            policy):
    from repro_torch.launch import dryrun as D
    from repro_torch.train.optimizer import AdamWConfig
    cfg, shape = _dryrun_cell(kind, policy)
    pred = D._lower_cell(cfg, shape, D.parse_mesh("1x1"), AdamWConfig())
    got = D.measure_cell(cfg, shape, device=cuda)
    assert got["finite"]
    assert abs(pred.peak_bytes - got["peak_bytes"]) <= 0.05 * got["peak_bytes"]
    assert pred.summary.flops == got["flops"]
    assert pred.summary.launches == got["launches"] == got["counted"]


def test_dots_keeps_the_launches_and_repeats_bit_for_bit(cuda):
    """One train step under "nothing" and two under "dots" from the same
    seeded state: the same K1 and backward launches (K1 twice a layer, the
    period checkpoint recomputing attention under both), the same loss,
    and the two "dots" runs equal to the bit in every parameter."""
    from repro_torch.launch import dryrun as D
    from repro_torch.train import train_state as TS
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.tree import leaves
    opt_cfg = AdamWConfig()
    runs = []
    for policy in ("nothing", "dots", "dots"):
        cfg, shape = _dryrun_cell("train", policy)
        g = torch.Generator(device=cuda).manual_seed(0)
        state = TS.init_state(g, cfg, opt_cfg, device=cuda)
        batch, _ = D.batch_specs(cfg, shape, device=cuda, gen=g)
        ops.reset_launch_counts()
        state, metrics = D.make_train_step(cfg, opt_cfg, D.parse_mesh("1x1"))(
            state, batch)
        torch.cuda.synchronize()
        runs.append((dict(ops.launch_counts()), float(metrics["loss"]),
                     [x.clone() for x in leaves(state["params"])]))
        del state, batch
    (c0, l0, _), (c1, l1, p1), (c2, l2, p2) = runs
    assert c0 == c1 == c2
    assert c0["mha_forward"] == 2 * cfg.n_layers
    assert c0["mha_backward"] == cfg.n_layers
    assert l0 == l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


# ----------------------------------------------------------------------
# sharding inside a stage: sequence-parallel attention's offset queries
# and the shard group's step on a mesh that repeats the card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("chunk,n_chunks,segmented", [
    (0, 4, False), (1, 4, False), (3, 4, False), (2, 4, True), (1, 2, True)])
def test_causal_backward_with_queries_at_an_offset(cuda, d, chunk, n_chunks,
                                                   segmented):
    """Sequence-parallel attention hands K1 and the backward one shard's
    query rows at their own positions with every key: Tq = T / tp < Tk,
    causal by position. Both against their plain versions."""
    b, s, h, kv = 2, 256, 4, 2
    t = s // n_chunks
    q, k, v, _, kp = _inputs(cuda, b, s, s, h, kv, d)
    q = q[:, chunk * t:(chunk + 1) * t].contiguous()
    qp = kp[:, chunk * t:(chunk + 1) * t].contiguous()
    qs = ks = None
    if segmented:       # packed rows: a second segment, a padded tail
        ks = torch.zeros((b, s), dtype=torch.int32, device=cuda)
        ks[0, 100:] = 1
        ks[1, 200:] = -1
        kp = torch.where(ks[:, :, None] == 1, kp[:, :, None] - 100,
                         kp[:, :, None])[..., 0].contiguous()
        qs = ks[:, chunk * t:(chunk + 1) * t].contiguous()
        qp = kp[:, chunk * t:(chunk + 1) * t].contiguous()
    o, lse = fa.mha_forward(q, k, v, qp, kp, qs, ks, causal=True)
    o_ref, _ = fa.mha_forward_plain(q, k, v, qp, kp, qs, ks, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    do = torch.randn_like(o)
    out = fa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do, causal=True)
    ref = fa.mha_backward_plain(q, k, v, qp, kp, qs, ks, o, lse, do,
                                causal=True)
    for a, r in zip(out, ref):
        _grad_close(a, r)


@pytest.mark.parametrize("shape,attn_tp", [((2, 2), True), ((1, 4), False)])
def test_spmd_step_on_a_mesh_of_the_card_matches_the_meshfree_step(
        cuda, shape, attn_tp):
    """The reduced gpt-paper step on a (2, 2) mesh (head-parallel) and a
    (1, 4) mesh with ``attn_tp=False`` (sequence-parallel) of ``cuda:0``
    against the same step with no mesh: every shard launches K1 and the
    backward (forward, the period recompute, one backward a layer), and
    the gradients agree leaf by leaf."""
    import dataclasses
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.pipeline_adapter import build_grad_step
    from repro_torch.train.train_state import join_params
    from repro_torch.tree import flatten
    cfg = dataclasses.replace(SV.make_config("gpt-paper", "reduced", 2),
                              attn_tp=attn_tp)
    params = MD.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    r = np.random.default_rng(0)
    seg = np.zeros((2, 128), np.int32)
    seg[0, 70:] = 1
    seg[1, 90:] = -1
    pos = np.where(seg == 1, np.arange(128) - 70,
                   np.where(seg >= 0, np.arange(128), 0)).astype(np.int32)
    batch = _to({k: torch.from_numpy(v) for k, v in {
        "tokens": r.integers(0, cfg.vocab, (2, 128)).astype(np.int32),
        "labels": r.integers(0, cfg.vocab, (2, 128)).astype(np.int32),
        "loss_weights": (seg >= 0).astype(np.float32),
        "positions": pos, "segment_ids": seg}.items()}, cuda)
    step = build_grad_step(cfg)
    l0, w0, g0 = step(params, batch)
    mesh = make_mesh(shape, ("data", "model"), devices=["cuda:0"] * 4)
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        with set_mesh(mesh):
            ls, ws, g = step(params, batch)
        runs.append((ls, ws, join_params(g), dict(ops.launch_counts())))
    (l1, w1, g1, c1), (l2, _, g2, _) = runs
    assert c1["mha_forward"] == 4 * 2 * cfg.n_layers
    assert c1["mha_backward"] == 4 * cfg.n_layers
    assert float(w1) == float(w0)
    torch.testing.assert_close(l1, l0, atol=GRAD_TOL, rtol=GRAD_TOL)
    for (_, a), (_, b) in zip(flatten(g1), flatten(g0)):
        _grad_close(a, b)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(g1), flatten(g2)))


# ----------------------------------------------------------------------
# Mamba's tensor parallelism: K4 and its backward on each shard's heads
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,t,h,p,g,n", [
    (1, 2048, 6, 64, 1, 128),      # mamba2-130m's 24 heads over 4 shards
    (1, 2048, 32, 128, 1, 128),    # jamba's 128 heads over 4 shards
])
def test_ssd_kernels_at_the_shard_shapes_match_plain_versions(cuda, b, t, h,
                                                              p, g, n):
    args = _ssd_inputs(cuda, b, t, h, p, g, n)
    ops.reset_launch_counts()
    y, st, _ = SSD._ssd_cuda(*args, chunk_states=True)
    y_ref, st_ref = tref.ssd_ref_chunked(*args)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    torch.testing.assert_close(st, st_ref, atol=SSD_TOL, rtol=SSD_TOL)
    gen = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn((b, t, h, p), generator=gen, device=cuda
                     ).to(torch.bfloat16)
    got, want = _ssd_bwd_both(args, dy)
    assert ops.launch_counts()["ssd_backward"] == 1
    for name, o, w in zip(SSD_NAMES, got, want):
        if name == "d_initial":
            continue
        rel = (_whole_rel(o, w) if name == "dA" else _per_chunk_rel(o, w))
        assert rel <= 1e-2, (name, rel)


def test_mamba_tp_step_on_a_mesh_of_the_card_matches_the_meshfree_step(
        cuda):
    """The reduced mamba2-130m step on a (1, 2) mesh of ``cuda:0`` (each
    shard K4 and its backward on 4 of the 8 heads) against the step with
    no mesh: twice the launches, the gradients leaf by leaf, and two runs
    equal to the bit."""
    import dataclasses
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.pipeline_adapter import build_grad_step
    from repro_torch.train.train_state import join_params
    from repro_torch.tree import flatten
    cfg = SV.make_config("mamba2-130m", "reduced", 2)
    params = MD.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    r = np.random.default_rng(0)
    batch = _to({k: torch.from_numpy(v) for k, v in {
        "tokens": r.integers(0, cfg.vocab, (2, 128)).astype(np.int32),
        "labels": r.integers(0, cfg.vocab, (2, 128)).astype(np.int32),
        "loss_weights": np.ones((2, 128), np.float32),
        "positions": np.tile(np.arange(128, dtype=np.int32), (2, 1)),
        "segment_ids": np.zeros((2, 128), np.int32)}.items()}, cuda)
    step = build_grad_step(cfg)
    ops.reset_launch_counts()
    l0, w0, g0 = step(params, batch)
    free = dict(ops.launch_counts())
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        with set_mesh(mesh):
            ls, ws, g = step(params, batch)
        runs.append((ls, ws, join_params(g), dict(ops.launch_counts())))
    (l1, w1, g1, c1), (l2, _, g2, _) = runs
    assert free["ssd_chunked"] == 2 * cfg.n_layers
    assert c1 == {k: 2 * v for k, v in free.items()}
    assert float(w1) == float(w0)
    torch.testing.assert_close(l1, l0, atol=GRAD_TOL, rtol=GRAD_TOL)
    # by norm per leaf within SSD_TOL: the row-parallel out_proj rounds
    # each shard's partial to bf16 before the sum (about 2e-2 at this
    # width on the CPU)
    for (_, a), (_, b) in zip(flatten(g1), flatten(g0)):
        assert _whole_rel(a, b) <= SSD_TOL
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten(g1), flatten(g2)))


@pytest.mark.parametrize("arch", ["gpt-paper", "mamba2-130m"])
def test_sharded_serve_on_a_mesh_of_the_card_matches_the_meshfree_serve(
        cuda, arch):
    """The reduced model's prefill (2 x 128 into a 132-position cache) and
    4 decode steps on a (1, 4) mesh of ``cuda:0`` against the same serve
    with no mesh, fed the same tokens: K1 (gpt-paper: each shard's heads
    in prefill, each shard's slice of the cache in decode) or K4 (Mamba's
    prefill on each shard's 2 heads) launched 4 times as often; each
    step's last logits and each cache leaf, joined, within TOL by norm;
    gpt-paper's decode fails that check with the merge of K1's partials
    planted to leave out the last model shard's."""
    from unittest import mock
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.launch.mesh import make_mesh
    cfg = SV.make_config(arch, "reduced", 2)
    params = MD.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    r = np.random.default_rng(0)
    b, t, steps = 2, 128, 4
    batch = _to({"tokens": torch.from_numpy(
        r.integers(0, cfg.vocab, (b, t)).astype(np.int32)),
        "positions": torch.arange(t, dtype=torch.int32)[None].expand(
            b, t).contiguous()}, cuda)
    feed = torch.from_numpy(r.integers(0, cfg.vocab, (b, steps)).astype(
        np.int32)).to(cuda)

    def serve(mesh):
        ops.reset_launch_counts()
        with set_mesh(mesh), torch.inference_mode():
            logits, cache = MD.prefill(params, batch, cfg, cache_len=t + steps)
            out = [logits]
            for i in range(steps):
                logits, cache = MD.decode(params, {
                    "tokens": feed[:, i:i + 1], "cache": cache,
                    "cache_pos": t + i, "positions": torch.full(
                        (b, 1), t + i, dtype=torch.int32, device=cuda)}, cfg)
                out.append(logits)
        if mesh is not None:
            out = [spmd.join(x) for x in out]
            cache = tuple({k: spmd.join(v) for k, v in lc.items()}
                          for lc in cache)
        return out, cache, dict(ops.launch_counts())

    def rel(a, b):
        return float((torch.linalg.vector_norm(a - b, dim=-1)
                      / torch.linalg.vector_norm(b, dim=-1)).max())

    free, free_cache, free_counts = serve(None)
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cuda:0"] * 4)
    got, cache, counts = serve(mesh)
    kernel = "ssd_chunked" if cfg.has_mamba else "mha_forward"
    assert free_counts[kernel] > 0
    assert counts[kernel] == 4 * free_counts[kernel]
    assert max(rel(a, b) for a, b in zip(got, free)) <= TOL
    for lc, lf in zip(cache, free_cache):
        for k in lc:
            assert _whole_rel(lc[k], lf[k]) <= TOL, k
    if cfg.has_mamba:
        return
    real = spmd.merge_partials
    with mock.patch.object(spmd, "merge_partials",
                           lambda os_, ls_: real(os_[:-1], ls_[:-1])):
        bad, _, _ = serve(mesh)
    assert max(rel(a, b) for a, b in zip(bad[1:], free[1:])) > TOL

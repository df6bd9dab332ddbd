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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
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
                                   "ssd_chunked": 0}
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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
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


@pytest.mark.parametrize("case", sorted(REPEAT_CASES))
def test_backward_kernel_is_repeatable_bit_for_bit(cuda, case):
    # dq's tiles are added in ascending key tile, so two calls agree to the
    # bit, as dk and dv do
    t, h, kv, lengths = REPEAT_CASES[case]
    q, k, v, qp, kp = _inputs(cuda, 2, t, t, h, kv, 128, seed=3)
    qs = ks = None
    if lengths is not None:
        qp, qs = _segments(cuda, 2, t, lengths)
        kp, ks = qp, qs
    o, lse = fa.mha_forward(q, k, v, qp, kp, qs, ks, causal=True)
    do = torch.randn_like(o)
    first = fa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do, causal=True)
    for _ in range(3):
        again = fa.mha_backward(q, k, v, qp, kp, qs, ks, o, lse, do,
                                causal=True)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), f"{case}: {name} differs between calls"
    ref = fa.mha_backward_plain(q, k, v, qp, kp, qs, ks, o, lse, do,
                                causal=True)
    for a, r in zip(first, ref):
        _grad_close(a, r)
    if case == "dead-query-tile":
        assert (first[0][0, 190:] == 0).all()


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
                            causal=True, window=0, softcap=None)
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
                            causal=False, window=0, softcap=None, sem=sem)
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
                                       "ssd_chunked": 0}
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
                                   "ssd_chunked": 0}
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
                                       "ssd_chunked": 0}
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


def test_ssd_kernel_refuses_a_gradient_and_an_initial_state(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 8, 2, 16, 1, 16)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd(x, dt, A.clone().requires_grad_(), B, C)
    with pytest.raises(NotImplementedError, match="initial state"):
        ops.ssd(x, dt, A, B, C,
                initial_state=torch.zeros((1, 2, 16, 16), device=cuda))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.ssd(x.float(), dt, A, B, C)


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
                                   "ssd_chunked": cfg.n_layers * nb}
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

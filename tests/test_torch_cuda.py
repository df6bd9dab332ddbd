"""The CUDA kernel K1 on the card, against its plain version and the CPU.

Marked ``cuda``: each test skips where there is no card. On a machine with
one they run with ``PYTHONPATH=src python -m pytest -q -m cuda --noconftest
tests/test_torch_cuda.py`` (the repo's conftest imports the JAX package,
which such a machine need not have); ``chip_smoke.py`` checks the same at
the serving path's full widths. Tolerance 2e-2, the reference's bf16 kernel
tolerance (tests/test_kernels.py:28): the kernel rounds p to bf16 before
p·v, the plain version does not.
"""
import numpy as np
import pytest
import torch

from repro_torch import serve as SV
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import model as MD

pytestmark = pytest.mark.cuda
TOL = 2e-2


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
    q, k, v, qp, kp = _inputs(cuda, 1, 8, 8, 2, 2, 16)
    with pytest.raises(NotImplementedError, match="no backward"):
        fa.mha_forward(q.requires_grad_(), k, v, qp, kp, causal=True)


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

"""The port's dry run and cost counter against the reference's.

``repro_torch.launch.op_cost`` counts one eager step's aten ops (the
reference's ``hlo_cost`` parses optimized HLO), and
``repro_torch.launch.dryrun._lower_cell`` traces a cell's step on the
``meta`` device (the reference's lowers and compiles it). Here, on the
CPU, for reduced configs at seq 128 and batch 8 (U = B·H·T·S·D):

- the counter against ``FlopCounterMode`` on a loop-free product, and
  every iteration of a loop counted (the reference's two ``hlo_cost``
  tests);
- every kind ``cell_supported`` allows for gpt-paper, gemma2-2b,
  granite-moe, mamba2-130m, hubert-xlarge and llava-next on a (1, 1)
  mesh, against ``repro.launch.dryrun._lower_cell(...).compile()``:
  argument bytes equal to the byte; prefill and decode FLOPs equal (rel
  1e-6) where the arch has attention; train FLOPs the reference's plus 6 U
  per attention layer (the reference charges 12 U a layer for its dense
  ``ref`` attention, the port 18 U: K1 4, K1 again under the period
  checkpoint 4, the fused backward's five products 10); mamba2's prefill
  in closed form, K4's charge in place of the reference oracle's products
  and the oracle's depthwise convolution, which the port computes as
  shifted multiply-adds; mamba2's train cell recorded as not ported
  (ROADMAP D, K4 has no backward) with the reference's argument bytes;
- in one 4-device reference subprocess, gpt-paper on a (4, 1) mesh
  (argument bytes equal, FLOPs exactly a quarter of (1, 1)'s, the
  gradients' all-reduce and the ZeRO-1 all-gather within 1% of the
  reference's link bytes) and on a (2, 2) mesh, which the port records as
  not ported (ROADMAP A23) with the reference's argument bytes;
- the CLI once, into a temporary directory.
"""
import functools
import json
import math

import jax  # noqa: F401  (JAX beside torch, on the CPU)
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro  # noqa: F401  (the reference's jax compat shims)
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.launch import dryrun as JD
from repro.launch import hlo_cost as JH
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs.base import ShapeSpec, cell_supported, get_arch, reduced
from repro_torch.kernels.ssd import ssd_cost
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_cost as OC
from repro_torch.train.optimizer import AdamWConfig
from tests.conftest import run_subprocess_devices

torch.set_num_threads(1)

ARCHS = ["gpt-paper", "gemma2-2b", "granite-moe-3b-a800m", "mamba2-130m",
         "hubert-xlarge", "llava-next-34b"]
SEQ, BATCH = 128, 8
CASES = [(a, k) for a in ARCHS for k in ("train", "prefill", "decode")
         if cell_supported(reduced(get_arch(a)),
                           ShapeSpec("t", k, SEQ, BATCH))[0]]


def _shape(kind):
    return ShapeSpec(f"{kind}_t", kind, SEQ, BATCH)


def _u(cfg) -> int:
    return BATCH * cfg.n_heads * SEQ * SEQ * cfg.d_head


def _attn_layers(cfg) -> int:
    return sum(s.mixer != "mamba" for s in cfg.layer_pattern) * cfg.n_periods


@functools.lru_cache(maxsize=None)
def _reference(arch, kind):
    """(argument bytes, hlo_cost FLOPs) of the reference's compiled cell
    on a (1, 1) mesh."""
    cfg = j_reduced(j_get_arch(arch))
    mesh = j_make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        c = JD._lower_cell(cfg, JShapeSpec(f"{kind}_t", kind, SEQ, BATCH),
                           mesh, JAdamWConfig()).compile()
    return (c.memory_analysis().argument_size_in_bytes,
            JH.analyze(c.as_text()).flops)


def _port_record(arch, kind, mesh="1x1"):
    return D.run_cell(arch, f"{kind}_t", False, save=False, verbose=False,
                      mesh=D.parse_mesh(mesh), cfg=reduced(get_arch(arch)),
                      shape=_shape(kind))


# ----------------------------------------------------------------------
# the counter (the reference's test_hlo_cost_* in tests/test_planner_loop.py)
# ----------------------------------------------------------------------
def test_op_cost_matches_flop_counter_loop_free():
    x = torch.ones((256, 256))
    counter = FlopCounterMode(display=False)
    with counter:
        x @ x
    _, got = OC.analyze(lambda a: a @ a, x)
    want = counter.get_total_flops()
    assert abs(got.flops - want) / want < 1e-6
    # operands and result, one pass each
    assert got.hbm_bytes == 3 * 256 * 256 * 4


def test_op_cost_counts_every_loop_iteration():
    x = torch.ones((128, 128))
    ws = torch.ones((12, 128, 128))

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x

    _, got = OC.analyze(looped, x, ws)
    expect = 12 * 2 * 128 ** 3
    assert abs(got.flops - expect) / expect < 0.05
    assert got.hbm_bytes > 12 * 128 * 128 * 4   # per-iteration traffic counted


def test_op_cost_peak_follows_live_storages_on_meta():
    """A backward on ``meta``: the peak holds the argument, the product and
    its saved input, and drops what dies."""
    x = torch.empty((1024, 1024), device="meta", requires_grad=True)

    def step(x):
        y = (x @ x).relu()
        return torch.autograd.grad(y.sum(), x)[0]

    g, got = OC.analyze(step, x)
    mb = 1024 * 1024 * 4
    assert got.flops == 3 * 2 * 1024 ** 3           # forward, two backward
    assert 3 * mb <= got.peak_live_bytes <= 6 * mb
    assert g.shape == x.shape


# ----------------------------------------------------------------------
# each cell against the reference's compiled one, (1, 1) mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_cell_matches_reference(arch, kind):
    cfg = reduced(get_arch(arch))
    ref_args, ref_flops = _reference(arch, kind)
    rec = _port_record(arch, kind)
    assert rec["memory"]["argument_bytes"] == ref_args
    if kind == "train" and cfg.has_mamba:
        assert rec["cost"] is None and rec["not_ported"] == "ROADMAP D"
        return
    flops = rec["cost"]["flops_per_device"]
    n_attn = _attn_layers(cfg)
    if cfg.has_mamba:
        # prefill: K4's charge in place of the reference oracle's products
        # (ssd_ref below 512 steps: C Bᵀ, then y, then the final state)
        # and of its depthwise convolution over [x | B | C]
        b, t, h = BATCH, SEQ, cfg.ssm_heads
        p, n = cfg.ssm_headdim, cfg.ssm_state
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * n
        layers = cfg.n_layers
        oracle = 2 * b * t * t * h * n + 2 * b * t * t * h * p \
            + 2 * b * h * p * n * t
        conv = 2 * b * t * conv_ch * cfg.ssm_conv
        # K4's loop (csrc/ssd_fwd.cu) at P = 16, its own instantiation, per
        # (batch row, head) and 64-step chunk: C Bᵀ on the 10 16 x 16
        # blocks up to the diagonal, by N; W x on them, by P, as hi and lo;
        # the state's update, P x N by 64, as hi and lo; and, in every
        # chunk but the first, the start state's C Sᵀ, 64 x P by N, as hi
        # and lo
        chunks = t // 64
        k4 = b * h * (chunks * (10 * 512 * n + 2 * 10 * 512 * p
                                + 4 * p * n * 64)
                      + (chunks - 1) * 4 * 64 * n * p)
        assert ssd_cost(b, t, h, p, n) == (k4, 0.0)
        if kind == "prefill":
            want = ref_flops + layers * (k4 - oracle - conv)
            assert rec["cost"]["launches"] == {"ssd_chunked": layers}
        else:
            want = ref_flops       # decode: no K4, the recurrence in both
        assert math.isclose(flops, want, rel_tol=1e-6)
        return
    want = ref_flops + (6 * _u(cfg) * n_attn if kind == "train" else 0)
    assert math.isclose(flops, want, rel_tol=1e-6)
    fwd = (2 if kind == "train" else 1) * n_attn
    assert rec["cost"]["launches"] == (
        {"mha_forward": fwd, "mha_backward": n_attn} if kind == "train"
        else {"mha_forward": fwd})
    assert rec["cost"]["padded_flops_per_device"] == 0
    assert rec["memory"]["peak_bytes"] >= (
        rec["memory"]["argument_bytes"]
        + rec["memory"]["unread_argument_bytes"])


def test_k1_charge_is_dense_and_pads_apart():
    """K1 and the backward charged on ``meta``: 4 U and 10 U of the true
    head dim, the columns of head dim 80 padded to 128 in a field apart."""
    from repro_torch.kernels import flash_attention as fa
    b, t, h, kv, d = 2, 64, 4, 2, 80
    q = torch.empty((b, t, h, d), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty((b, t, kv, d), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)

    def step(q, k, v):
        o = fa.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o.float().sum(), (q, k, v))

    grads, got = OC.analyze(step, q, k, v)
    u = b * h * t * t
    assert got.launches == {"mha_forward": 1, "mha_backward": 1}
    assert got.flops == (4 + 10) * u * d
    assert got.padded_flops == (4 + 10) * u * (128 - d)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


# ----------------------------------------------------------------------
# 4 devices: (4, 1) and (2, 2) meshes
# ----------------------------------------------------------------------
_MESH_CODE = """
import json, jax, repro
from repro.configs.base import get_arch, reduced, ShapeSpec
from repro.launch import dryrun as JD, hlo_cost as JH
from repro.launch.mesh import make_mesh
from repro.train.optimizer import AdamWConfig
cfg = reduced(get_arch("gpt-paper"))
out = {}
for mesh_shape, kinds in (((4, 1), ("train", "prefill", "decode")),
                          ((2, 2), ("train",))):
    mesh = make_mesh(mesh_shape, ("data", "model"))
    for kind in kinds:
        with jax.set_mesh(mesh):
            c = JD._lower_cell(cfg, ShapeSpec(kind + "_t", kind, 128, 8),
                               mesh, AdamWConfig()).compile()
        hc = JH.analyze(c.as_text())
        out["%dx%d-%s" % (*mesh_shape, kind)] = {
            "args": c.memory_analysis().argument_size_in_bytes,
            "flops": hc.flops, "link": hc.coll_link_bytes}
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_meshes():
    out = run_subprocess_devices(_MESH_CODE, n_devices=4, timeout=600)
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_gpt_paper_on_four_data_devices(reference_meshes, kind):
    ref = reference_meshes[f"4x1-{kind}"]
    rec = _port_record("gpt-paper", kind, "4x1")
    whole = _port_record("gpt-paper", kind, "1x1")
    assert rec["n_chips"] == 4
    assert rec["memory"]["argument_bytes"] == ref["args"]
    assert rec["cost"]["flops_per_device"] == \
        whole["cost"]["flops_per_device"] / 4
    if kind != "train":
        assert math.isclose(rec["cost"]["flops_per_device"], ref["flops"],
                            rel_tol=1e-6)
        assert rec["collectives"]["link_bytes"] == {} == ref["link"]
        return
    link = rec["collectives"]["link_bytes"]
    assert set(link) == set(ref["link"]) == {"all-reduce", "all-gather"}
    for kind_, b in ref["link"].items():
        assert abs(link[kind_] - b) / b < 0.01, (kind_, link[kind_], b)
    assert rec["collectives_trip_aware"] == rec["collectives"]


def test_model_axis_cell_records_state_bytes_only(reference_meshes):
    rec = _port_record("gpt-paper", "train", "2x2")
    assert rec["cost"] is None and rec["not_ported"] == "ROADMAP A23"
    assert rec["memory"]["argument_bytes"] == reference_meshes["2x2-train"][
        "args"]
    with pytest.raises(NotImplementedError, match="A23"):
        D._lower_cell(reduced(get_arch("gpt-paper")), _shape("train"),
                      D.parse_mesh("2x2"), AdamWConfig())


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_cli_writes_records(tmp_path, capsys, monkeypatch):
    """The CLI on the production mesh (A23: state bytes only) and on a 1x1
    mesh (the trace), at full size for mamba2-130m's decode_32k: every
    record keeps the reference's keys."""
    D.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)])
    D.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
            "1x1", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "1 cells recorded without a cost" in out
    assert out.count("ALL DRY-RUN CELLS PASSED") == 2
    prod = json.loads((tmp_path / "mamba2-130m__decode_32k__16x16.json")
                      .read_text())
    assert prod["not_ported"] == "ROADMAP A23" and prod["cost"] is None
    one = json.loads((tmp_path / "mamba2-130m__decode_32k__1x1.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "runnable", "skip_reason",
                "n_chips", "lower_s", "compile_s", "memory", "cost",
                "collectives", "collectives_trip_aware", "model"):
        assert key in one, key
    for key in ("argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
                "alias_bytes", "device_bytes_est"):
        assert key in one["memory"], key
    for key in ("flops_per_device", "bytes_per_device",
                "hlo_flops_per_device", "hlo_hbm_bytes_per_device"):
        assert one["cost"][key] > 0, key
    # the decode step writes the cache in place: an output that aliases
    assert one["memory"]["alias_bytes"] > 0
    # --skip-existing finds it; a bad arch exits 1
    D.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
            "1x1", "--skip-existing", "--out", str(tmp_path)])
    assert "[skip existing]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        D.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                "--out", str(tmp_path)])

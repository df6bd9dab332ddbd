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
  shifted multiply-adds; mamba2's train cell in closed form too, K4
  twice and its backward's charge in place of the reference's oracle and
  convolution under ``jax.grad`` and its checkpoint;
- in one 4-device reference subprocess, gpt-paper on a (4, 1) mesh
  (argument bytes equal, FLOPs exactly a quarter of (1, 1)'s, the
  gradients' all-reduce and the ZeRO-1 all-gather within 1% of the
  reference's link bytes); gpt-paper and mamba2-130m train cells on (2, 2)
  and (1, 4), traced in a shard group on ``meta`` (argument bytes equal
  to the byte, FLOPs per device the reference's related as on (1, 1) at
  the shard's share, within 1%, each term where the two programs do
  different work named; link bytes printed beside the reference's);
  gpt-paper's prefill and decode, mamba2-130m's decode and llava-next's
  prefill on (2, 2) and (1, 4), traced in a shard group with sharded
  caches, held the same way; t5-paper's train, prefill and decode on (2,
  2) and (1, 4), the decoder-only stack at T5's widths as the reference
  lowers it there, held the same way;
- a representative rank's trace against a trace of every rank on (2, 2);
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
from repro_torch.kernels.flash_attention import sm_count
from repro_torch.kernels.ssd import bwd_plan, ssd_bwd_cost, ssd_cost
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
    flops = rec["cost"]["flops_per_device"]
    n_attn = _attn_layers(cfg)
    if cfg.has_mamba:
        # K4's charge in place of the reference oracle's products (ssd_ref
        # below 512 steps: C Bᵀ, then y, and in prefill the final state)
        # and of its depthwise convolution over [x | B | C]
        b, t, h = BATCH, SEQ, cfg.ssm_heads
        p, n = cfg.ssm_headdim, cfg.ssm_state
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * n
        layers = cfg.n_layers
        oracle = 2 * b * t * t * h * n + 2 * b * t * t * h * p
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
            # the final state's product beside them
            want = ref_flops + layers * (k4 - oracle - 2 * b * h * p * n * t
                                         - conv)
            assert rec["cost"]["launches"] == {"ssd_chunked": layers}
        elif kind == "train":
            # train: K4 twice (the forward, and the period checkpoint's
            # recompute) and the backward's charge, in place of the
            # reference's under jax.grad and its checkpoint: the oracle's
            # two products (no final state) twice and their four
            # gradients, the depthwise convolution twice and its two
            # gradients, which the reference's hlo_cost counts as dense
            # C x C convolutions (2·B·T·K·C² each); and the port runs the
            # one-chunk loss's logits product twice (the forward and the
            # chunk checkpoint's recompute), where the reference's XLA
            # shares it between the two
            # K4's backward (csrc/ssd_bwd.cu) at P = 16, per (batch row,
            # head) and 64-step chunk: dy xᵀ (by P) on the 10 blocks up to
            # the diagonal; Wᵀ dy on them by P, as hi and lo; the dS'
            # walk's update, B dS'ᵀ, dy S and x dS', 64 x P x N each, as hi
            # and lo; M B and Mᵀ C on the 10 blocks by N, as hi and lo; and
            # per (batch row, chunk, group and head tile) C Bᵀ on the 10
            # blocks by N, shared by the tile's heads
            g = cfg.ssm_groups
            _, tiles = bwd_plan(b, t, h, g, sm_count("meta"))
            bwd = b * h * (t // 64) * (
                10 * 512 * p + 2 * 10 * 512 * p
                + 4 * (4 * 64 * p * n) + 2 * (2 * 10 * 512 * n)) \
                + b * (t // 64) * g * tiles * 10 * 512 * n
            assert ssd_bwd_cost(b, t, h, p, n, g, tiles) == (bwd, 0.0)
            oracle_train = 4 * oracle    # forward, recompute, 4 gradients
            conv_train = 2 * conv + 2 * (2 * b * t * cfg.ssm_conv * conv_ch ** 2)
            logits = 2 * b * t * cfg.vocab * cfg.d_model
            want = ref_flops + layers * (2 * k4 + bwd - oracle_train
                                         - conv_train) + logits
            assert rec["cost"]["launches"] == {"ssd_chunked": 2 * layers,
                                               "ssd_backward": layers}
            assert rec["cost"]["padded_flops_per_device"] == 0
            assert rec["memory"]["peak_bytes"] >= (
                rec["memory"]["argument_bytes"]
                + rec["memory"]["unread_argument_bytes"])
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
out = {}
for arch, mesh_shape, kinds in (
        ("gpt-paper", (4, 1), ("train", "prefill", "decode")),
        ("gpt-paper", (2, 2), ("train", "prefill", "decode")),
        ("gpt-paper", (1, 4), ("train", "prefill", "decode")),
        ("mamba2-130m", (2, 2), ("train", "decode")),
        ("mamba2-130m", (1, 4), ("train", "decode")),
        ("llava-next-34b", (2, 2), ("prefill",)),
        ("llava-next-34b", (1, 4), ("prefill",)),
        ("t5-paper", (2, 2), ("train", "prefill", "decode")),
        ("t5-paper", (1, 4), ("train", "prefill", "decode"))):
    cfg = reduced(get_arch(arch))
    mesh = make_mesh(mesh_shape, ("data", "model"))
    for kind in kinds:
        with jax.set_mesh(mesh):
            c = JD._lower_cell(cfg, ShapeSpec(kind + "_t", kind, 128, 8),
                               mesh, AdamWConfig()).compile()
        hc = JH.analyze(c.as_text())
        key = "%dx%d-%s" % (*mesh_shape, kind)
        out[key if arch == "gpt-paper" else arch + "-" + key] = {
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


def _mamba_train_terms(cfg):
    """The terms of mamba2's train FLOPs at (1, 1) where the port and the
    reference differ (see test_cell_matches_reference): K4 twice and its
    backward against the oracle's products; the depthwise convolution,
    whose two gradients the reference's hlo_cost counts as dense C x C
    convolutions; the loss's logits product, which the port runs twice."""
    b, t, h = BATCH, SEQ, cfg.ssm_heads
    p, n = cfg.ssm_headdim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * n
    oracle = 2 * b * t * t * h * n + 2 * b * t * t * h * p
    conv = 2 * b * t * conv_ch * cfg.ssm_conv
    conv_grads = 2 * (2 * b * t * cfg.ssm_conv * conv_ch ** 2)
    return oracle, conv, conv_grads


@pytest.mark.parametrize("arch,mesh", [("gpt-paper", "2x2"),
                                       ("gpt-paper", "1x4"),
                                       ("mamba2-130m", "2x2"),
                                       ("mamba2-130m", "1x4"),
                                       ("t5-paper", "2x2"),
                                       ("t5-paper", "1x4")])
def test_train_cell_on_a_model_axis_matches_reference(reference_meshes,
                                                      arch, mesh, capsys):
    """A train cell on a mesh with a model axis, traced in a shard group
    on ``meta`` at one device's share, against the reference's compiled
    GSPMD program on the same mesh. FLOPs per device: the (1, 1)
    relation at the shard's share (1/4 on these 4-device meshes), with
    two terms where the programs do different work: the port's period
    checkpoint recomputes each period's last product (the recompute runs
    the whole period in a shard group: ``spmd.whole_recompute``), and the
    reference's partitioned loss computes its vocabulary-sharded logits
    product once more than its (1, 1) program does."""
    cfg = reduced(get_arch(arch))
    key = (f"{mesh}-train" if arch == "gpt-paper"
           else f"{arch}-{mesh}-train")
    ref = reference_meshes[key]
    d, m = (int(x) for x in mesh.split("x"))
    n_dev = d * m
    rec = _port_record(arch, "train", mesh)
    _, ref11 = _reference(arch, "train")
    assert rec["n_chips"] == n_dev and "not_ported" not in rec
    assert rec["memory"]["argument_bytes"] == ref["args"]
    tokens = BATCH * SEQ
    logits = 2 * tokens * cfg.vocab * cfg.d_model
    if cfg.has_mamba:
        # the period's last product: out_proj
        last = 2 * tokens * cfg.d_inner * cfg.d_model
        oracle, conv, conv_grads = _mamba_train_terms(cfg)
        g = cfg.ssm_groups
        _, tiles = bwd_plan(BATCH, SEQ, cfg.ssm_heads, g, sm_count("meta"))
        k4, _ = ssd_cost(BATCH, SEQ, cfg.ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state)
        bwd, _ = ssd_bwd_cost(BATCH, SEQ, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state, g, tiles)
        layers = cfg.n_layers
        port11 = ref11 + layers * (2 * k4 + bwd - 4 * oracle - 2 * conv
                                   - conv_grads) + logits
        # the reference's dense convolution gradients split over the
        # channels on both sides: (C/m)² a device, not C²/m
        ref_dev = (ref11 - layers * conv_grads) / n_dev \
            + layers * conv_grads / (d * m * m) + logits / n_dev
        assert math.isclose(ref["flops"], ref_dev, rel_tol=0.01)
        want = port11 / n_dev + layers * last / n_dev
        assert rec["cost"]["launches"] == {"ssd_chunked": 2 * layers,
                                           "ssd_backward": layers}
    else:
        last = 2 * tokens * cfg.d_ff * cfg.d_model       # the MLP's w_out
        n_attn = _attn_layers(cfg)
        ref_dev = ref["flops"] - logits / n_dev
        assert math.isclose(ref_dev, ref11 / n_dev, rel_tol=0.01)
        want = (ref11 + 6 * _u(cfg) * n_attn) / n_dev \
            + cfg.n_periods * last / n_dev
        assert rec["cost"]["launches"] == {"mha_forward": 2 * n_attn,
                                           "mha_backward": n_attn}
    assert math.isclose(rec["cost"]["flops_per_device"], want, rel_tol=0.01)
    link = rec["collectives"]["link_bytes"]
    with capsys.disabled():
        print(f"\n{arch} {mesh} collective link bytes per device, port vs "
              f"reference: " + ", ".join(
                  f"{k} {link.get(k, 0):.0f} / {ref['link'].get(k, 0):.0f}"
                  for k in sorted(set(link) | set(ref["link"])))
              + f"; total ratio {sum(link.values()) / sum(ref['link'].values()):.3f}")
    assert rec["collectives"]["counts"] and sum(link.values()) > 0


@pytest.mark.parametrize("arch", ["gpt-paper", "mamba2-130m", "qwen1.5-110b"])
def test_representative_rank_equals_every_rank(arch):
    """On (2, 2) the trace of rank 0 alone, its values standing in for
    the other ranks', counts what a trace of all four ranks counts for
    rank 0."""
    cfg = reduced(get_arch(arch))
    got = []
    for rep in (True, False):
        tr = D._lower_cell_group(cfg, _shape("train"), D.parse_mesh("2x2"),
                                 AdamWConfig(), representative=rep)
        s = tr.summary
        got.append((s.flops, s.hbm_bytes, dict(s.launches),
                    dict(s.coll_counts), dict(s.coll_link_bytes),
                    tr.peak_bytes, tr.argument_bytes, tr.output_bytes))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][2]


SERVE_MESH_CASES = [("gpt-paper", "prefill", "2x2"),
                    ("gpt-paper", "decode", "2x2"),
                    ("gpt-paper", "prefill", "1x4"),
                    ("gpt-paper", "decode", "1x4"),
                    ("mamba2-130m", "decode", "2x2"),
                    ("mamba2-130m", "decode", "1x4"),
                    ("llava-next-34b", "prefill", "2x2"),
                    ("llava-next-34b", "prefill", "1x4"),
                    ("t5-paper", "prefill", "2x2"),
                    ("t5-paper", "decode", "2x2"),
                    ("t5-paper", "prefill", "1x4"),
                    ("t5-paper", "decode", "1x4")]


@pytest.mark.parametrize("arch,kind,mesh", SERVE_MESH_CASES,
                         ids=[f"{a}-{k}-{m}" for a, k, m in SERVE_MESH_CASES])
def test_serve_cell_on_a_model_axis_matches_reference(reference_meshes,
                                                      arch, kind, mesh,
                                                      capsys):
    """A prefill or decode cell on a mesh with a model axis, traced in a
    shard group on ``meta`` (the KV and Mamba caches split by
    ``train_state.cache_spec_tree``), against the reference's compiled
    GSPMD program on the same mesh: argument bytes equal to the byte;
    FLOPs per device the (1, 1) relation (equal) at the shard's share,
    1/4 on these meshes, within 1%, with one term where the programs do
    different work: in Mamba's decode each model shard convolves every B
    and C channel of the window (2·B·K·2GN products a layer over its
    rows), which the reference's partitioned program splits over the
    model axis. Decode's K1 runs on every shard over its slice of the
    cache for every q head, at 1/4 of the keys: a quarter of the (1, 1)
    charge, as the reference's."""
    cfg = reduced(get_arch(arch))
    key = (f"{mesh}-{kind}" if arch == "gpt-paper"
           else f"{arch}-{mesh}-{kind}")
    ref = reference_meshes[key]
    d, m = (int(x) for x in mesh.split("x"))
    n_dev = d * m
    rec = _port_record(arch, kind, mesh)
    one = _port_record(arch, kind, "1x1")
    _, ref11 = _reference(arch, kind)
    assert rec["n_chips"] == n_dev and "not_ported" not in rec
    assert rec["memory"]["argument_bytes"] == ref["args"]
    assert one["cost"]["flops_per_device"] == ref11
    assert math.isclose(ref["flops"], ref11 / n_dev, rel_tol=0.01)
    extra = 0
    if cfg.has_mamba:
        bc = 2 * cfg.ssm_groups * cfg.ssm_state
        extra = cfg.n_layers * 2 * (BATCH // d) * cfg.ssm_conv * bc \
            * (1 - 1 / m)
    want = ref["flops"] + extra
    assert math.isclose(rec["cost"]["flops_per_device"], want,
                        rel_tol=0.01)
    assert math.isclose(rec["cost"]["flops_per_device"],
                        one["cost"]["flops_per_device"] / n_dev + extra,
                        rel_tol=1e-9)
    assert rec["cost"]["launches"] == one["cost"]["launches"]
    link = rec["collectives"]["link_bytes"]
    with capsys.disabled():
        print(f"\n{arch} {kind} {mesh} collective link bytes per device, "
              f"port vs reference: " + ", ".join(
                  f"{k} {link.get(k, 0):.0f} / {ref['link'].get(k, 0):.0f}"
                  for k in sorted(set(link) | set(ref["link"]))))
    assert rec["collectives"]["counts"] and sum(link.values()) > 0
    if kind == "decode" and cfg.has_attn:
        assert rec["collectives"]["counts"]["attention-merge"] == \
            cfg.n_layers


def test_model_axis_cell_records_state_bytes_only(reference_meshes):
    """T5 on a mesh with a model axis, once recorded without a cost, is
    now priced: its (2, 2) prefill cell records a cost, the reference's
    argument bytes and FLOPs at the shard's share of its compiled cell,
    and a trace equal to :func:`repro_torch.launch.dryrun._lower_cell`'s."""
    cfg = reduced(get_arch("t5-paper"))
    ref = reference_meshes["t5-paper-2x2-prefill"]
    rec = D.run_cell("t5-paper", "prefill_t", False, save=False,
                     verbose=False, mesh=D.parse_mesh("2x2"), cfg=cfg,
                     shape=_shape("prefill"))
    assert rec["cost"] is not None and "not_ported" not in rec
    assert rec["memory"]["argument_bytes"] == ref["args"]
    assert math.isclose(rec["cost"]["flops_per_device"], ref["flops"],
                        rel_tol=0.01)
    tr = D._lower_cell(cfg, _shape("prefill"), D.parse_mesh("2x2"),
                       AdamWConfig())
    assert tr.summary.flops == rec["cost"]["flops_per_device"]
    assert tr.peak_bytes == rec["memory"]["peak_bytes"]


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_cli_writes_records(tmp_path, capsys, monkeypatch):
    """The CLI on the production mesh (a shard group traced on meta, T5's
    decoder-only stack too) and on a 1x1 mesh (the trace), at full size
    for mamba2-130m's decode_32k: every record keeps the reference's keys,
    and none is without a cost."""
    D.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)])
    D.main(["--arch", "t5-paper", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)])
    D.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
            "1x1", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "without a cost" not in out and "NOT PORTED" not in out
    assert out.count("ALL DRY-RUN CELLS PASSED") == 3
    t5 = json.loads((tmp_path / "t5-paper__decode_32k__16x16.json")
                    .read_text())
    assert "not_ported" not in t5 and t5["n_chips"] == 256
    assert t5["cost"]["flops_per_device"] > 0
    assert t5["cost"]["launches"] == {
        "mha_forward": get_arch("t5-paper").n_layers}
    prod = json.loads((tmp_path / "mamba2-130m__decode_32k__16x16.json")
                      .read_text())
    assert "not_ported" not in prod and prod["n_chips"] == 256
    assert prod["cost"]["flops_per_device"] > 0
    assert prod["memory"]["peak_bytes"] >= prod["memory"]["argument_bytes"]
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


def test_cli_prices_a_zero3_train_cell_on_the_production_mesh(tmp_path,
                                                              capsys):
    """qwen1.5-110b's train_4k on the 16x16 production mesh (ZeRO-3
    weights, a model axis of 16): the CLI traces rank 0 of a shard group
    on meta and records a cost, its collectives the group's own (about 12
    s on the CPU)."""
    D.main(["--arch", "qwen1.5-110b", "--shape", "train_4k", "--mesh",
            "single", "--out", str(tmp_path)])
    assert "ALL DRY-RUN CELLS PASSED" in capsys.readouterr().out
    rec = json.loads((tmp_path / "qwen1.5-110b__train_4k__16x16.json")
                     .read_text())
    assert "not_ported" not in rec and rec["n_chips"] == 256
    n_attn = get_arch("qwen1.5-110b").n_layers
    assert rec["cost"]["launches"] == {"mha_forward": 2 * n_attn,
                                       "mha_backward": n_attn}
    assert rec["cost"]["flops_per_device"] > 0
    assert set(rec["collectives"]["counts"]) == {"all-gather", "all-reduce",
                                                 "reduce-scatter"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]

"""Per-layer time & memory cost models (paper §3 "Cost models", §8.6).

Two implementations behind one interface:

- :class:`AnalyticCostModel` — closed-form roofline model over TPU v5e
  constants (197 TFLOP/s bf16, 819 GB/s HBM). Used in this CPU-only container
  wherever the paper would read a profiled table, and calibrated by the same
  constants the dry-run roofline uses.
- :class:`ProfiledCostModel` — the paper's mechanism: measure fwd/bwd time
  and peak memory on a power-of-two (micro_batch, seq_len) grid and
  bilinearly interpolate in log2-space. ``profile_fn`` can wrap a real jitted
  step (tests profile a tiny model on CPU; on device it wraps the real model).

All times are seconds for a *stage* = ``n_layers / n_stages`` layers of the
model; memory is bytes of activation a single micro-batch pins on a stage
between its forward and backward pass.

Encoder-decoder models take 2D lengths (enc_len, dec_len); decoder-only
models use scalar lengths (dec_len = 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class HWSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # B/s per chip
    ici_bw: float = 50e9              # B/s per link
    hbm_bytes: float = 16e9           # per chip
    efficiency: float = 0.5           # sustained fraction of peak
    per_op_overhead: float = 5e-6     # dispatch overhead per stage step


V5E = HWSpec()


def _mxu_pad(n: int, align: int = 8) -> int:
    return max(align, -(-n // align) * align)


_SHAPE_BITS = 21                       # per-field width of a packed shape key
_SHAPE_MASK = (1 << _SHAPE_BITS) - 1


def encode_shape_triples(cnt, enc, dec):
    """Pack (cnt, enc, dec) int arrays into one int64 key each; None if any
    field exceeds the 21-bit range (callers fall back to row-wise unique)."""
    if cnt.size == 0:
        return np.empty(0, dtype=np.int64)
    if (int(cnt.max()) > _SHAPE_MASK or int(enc.max()) > _SHAPE_MASK
            or int(dec.max()) > _SHAPE_MASK):
        return None
    return ((cnt.astype(np.int64) << (2 * _SHAPE_BITS))
            | (enc.astype(np.int64) << _SHAPE_BITS)
            | dec.astype(np.int64))


def unique_shape_triples(cnt, enc, dec):
    """(cnt_u, enc_u, dec_u, inverse) over distinct (cnt, enc, dec) rows —
    a packed-int64 sort when the fields fit, row-wise np.unique otherwise."""
    keys = encode_shape_triples(cnt, enc, dec)
    if keys is not None:
        uk, inv = np.unique(keys, return_inverse=True)
        return (uk >> (2 * _SHAPE_BITS), (uk >> _SHAPE_BITS) & _SHAPE_MASK,
                uk & _SHAPE_MASK, inv)
    tri = np.stack([cnt, enc, dec], axis=1)
    u, inv = np.unique(tri, axis=0, return_inverse=True)
    return u[:, 0], u[:, 1], u[:, 2], inv


def _norm_seq_batch(mbs, seq) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mbs[], seq[] or seq[][2]) -> int64 arrays (mbs, enc, dec)."""
    m = np.asarray(mbs, dtype=np.int64).ravel()
    s = np.asarray(seq, dtype=np.int64)
    if s.ndim == 2:
        enc, dec = s[:, 0].copy(), s[:, 1].copy()
    else:
        enc = s.ravel().copy()
        dec = np.zeros_like(enc)
    if not (len(m) == len(enc) == len(dec)):
        raise ValueError(f"batch length mismatch: mbs={len(m)} seq={len(enc)}")
    return m, enc, dec


class CostModel:
    """Interface used by the planner / DP splitter / scheduler.

    Scalar methods (``stage_fwd_time`` etc.) are the original per-shape API.
    ``stage_times_batch`` is the vectorized entry the fast planning path
    (:func:`repro_torch.core.microbatch.dp_split`) uses exclusively; the base
    implementation falls back to a scalar loop so any subclass that only
    defines the scalar methods stays correct. Subclasses that override a
    scalar method *and* want the fast path to see it must override
    ``stage_times_batch`` consistently as well.
    """

    def stage_fwd_time(self, mbs: int, seq, tp: int = 1) -> float:
        raise NotImplementedError

    def stage_bwd_time(self, mbs: int, seq, tp: int = 1) -> float:
        return 2.0 * self.stage_fwd_time(mbs, seq, tp)

    def stage_time(self, mbs: int, seq, tp: int = 1) -> float:
        return self.stage_fwd_time(mbs, seq, tp) + self.stage_bwd_time(mbs, seq, tp)

    def stage_act_memory(self, mbs: int, seq, tp: int = 1) -> float:
        raise NotImplementedError

    # ----------------------- online calibration ------------------------
    # Models that expose learned ``fwd_scale``/``bwd_scale`` floats (both
    # concrete models below do) self-calibrate from measured stage timings.
    # A scale of exactly 1.0 is a bit-exact no-op (IEEE x*1.0 == x), so an
    # uncalibrated model plans identically to one without scales at all.
    def update(self, mbs: int, seq, fwd_s=None, bwd_s=None,
               ema: float = 0.25) -> None:
        """EMA the learned scales toward measured/predicted timing ratios.

        ``fwd_s``/``bwd_s`` are measured stage seconds for shape
        ``(mbs, seq)``; either may be None. No-op on models without scales.
        Ratios are clamped to [0.05, 20] so one outlier measurement (GC
        pause, page fault) cannot wreck the plan quality.
        """
        if not hasattr(self, "fwd_scale") or not hasattr(self, "bwd_scale"):
            return
        if fwd_s is not None and fwd_s > 0.0:
            base = self.stage_fwd_time(mbs, seq) / self.fwd_scale
            if base > 0.0:
                r = min(20.0, max(0.05, float(fwd_s) / base))
                self.fwd_scale = (1.0 - ema) * self.fwd_scale + ema * r
        if bwd_s is not None and bwd_s > 0.0:
            base = self.stage_bwd_time(mbs, seq) / self.bwd_scale
            if base > 0.0:
                r = min(20.0, max(0.05, float(bwd_s) / base))
                self.bwd_scale = (1.0 - ema) * self.bwd_scale + ema * r

    def scales(self) -> dict:
        return {"fwd_scale": getattr(self, "fwd_scale", 1.0),
                "bwd_scale": getattr(self, "bwd_scale", 1.0)}

    def stage_times_batch(self, mbs, seq, tp: int = 1):
        """Batched costs: ``(t_fwd[], t_bwd[], mem[])`` for k shapes.

        ``seq`` is ``(k,)`` (decoder-only) or ``(k, 2)`` (enc, dec) — a dec
        of 0 means decoder-only, matching the scalar convention of passing
        an int instead of a tuple. Fallback: loop over the scalar methods,
        bit-identical to calling them one shape at a time.
        """
        m, enc, dec = _norm_seq_batch(mbs, seq)
        k = len(m)
        tf = np.empty(k)
        tb = np.empty(k)
        mem = np.empty(k)
        for r in range(k):
            s = (int(enc[r]), int(dec[r])) if dec[r] else int(enc[r])
            tf[r] = self.stage_fwd_time(int(m[r]), s, tp)
            tb[r] = self.stage_bwd_time(int(m[r]), s, tp)
            mem[r] = self.stage_act_memory(int(m[r]), s, tp)
        return tf, tb, mem


class AnalyticCostModel(CostModel):
    def __init__(self, cfg: ArchConfig, n_stages: int = 1, hw: HWSpec = V5E,
                 remat: str = "full", bwd_mult: float = 1.0):
        self.cfg = cfg
        self.n_stages = n_stages
        self.hw = hw
        self.remat = remat  # "full" | "selective" | "none"
        # backward = bwd_mult * 2 * forward; recompute policies scale it
        # (core/recompute.py) — a plain field keeps the model picklable for
        # process-pool planning.
        self.bwd_mult = bwd_mult
        # learned per-term calibration (CostModel.update); plain floats keep
        # the model picklable, and 1.0 is a bit-exact identity
        self.fwd_scale = 1.0
        self.bwd_scale = 1.0

    # -------------------- flops / bytes per layer ----------------------
    def _layer_flops_per_seq(self, mbs: int, seq: int, spec) -> float:
        """Forward FLOPs of one layer over one micro-batch row of length seq."""
        cfg = self.cfg
        d = cfg.d_model
        t = seq
        fl = 0.0
        if spec.mixer.startswith("attn"):
            h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
            fl += 2 * t * d * (h * dh)            # q proj
            fl += 2 * 2 * t * d * (kv * dh)        # k,v proj
            fl += 2 * t * (h * dh) * d             # o proj
            eff_ctx = t / 2
            if spec.mixer == "attn_local" and cfg.window and t > cfg.window:
                eff_ctx = cfg.window / 2 + (t - cfg.window) * cfg.window / t
            if not cfg.causal:
                eff_ctx = t
            fl += 2 * 2 * t * eff_ctx * (h * dh)   # qk^T and pv
        elif spec.mixer == "mamba":
            di, g, n, hh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            fl += 2 * t * d * (2 * di + 2 * g * n + hh)     # in_proj
            fl += 2 * t * (di + 2 * g * n) * cfg.ssm_conv    # conv
            chunk = min(128, t)
            p = cfg.ssm_headdim
            # SSD: intra-chunk (CB^T: T_c*N, w@x: T_c*P) + state (2*N*P)
            fl += 2 * t * hh * (chunk * n + chunk * p + 2 * n * p)
            fl += 2 * t * di * d                              # out_proj
        if spec.moe:
            mult = 3 if cfg.mlp_gated else 2
            k_active = cfg.top_k * cfg.capacity_factor + cfg.n_shared_experts
            fl += 2 * t * d * cfg.d_ff_expert * mult * k_active
            fl += 2 * t * d * cfg.n_experts                   # router
        elif cfg.d_ff:
            mult = 3 if cfg.mlp_gated else 2
            fl += 2 * t * d * cfg.d_ff * mult
        return mbs * fl

    def _layer_bytes_per_seq(self, mbs: int, seq: int, spec) -> float:
        """HBM traffic of one layer (weights once + activations)."""
        cfg = self.cfg
        d = cfg.d_model
        wbytes = 0.0
        if spec.mixer.startswith("attn"):
            wbytes += 2 * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
                           + cfg.n_heads * cfg.d_head * d)
        elif spec.mixer == "mamba":
            di, g, n, hh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            wbytes += 2 * (d * (2 * di + 2 * g * n + hh) + di * d)
        if spec.moe:
            mult = 3 if cfg.mlp_gated else 2
            act_e = min(cfg.n_experts, mbs * seq * cfg.top_k)  # touched experts
            wbytes += 2 * mult * d * cfg.d_ff_expert * (act_e + cfg.n_shared_experts)
        elif cfg.d_ff:
            mult = 3 if cfg.mlp_gated else 2
            wbytes += 2 * mult * d * cfg.d_ff
        abytes = 2 * mbs * seq * d * 6  # rough activation reads+writes
        return wbytes + abytes

    def _mean_layer(self, fn, mbs, seq) -> float:
        total = 0.0
        for spec in self.cfg.layer_pattern:
            total += fn(mbs, seq, spec)
        return total / len(self.cfg.layer_pattern)

    # --------------------------- interface -----------------------------
    def _norm_seq(self, seq) -> tuple[int, int]:
        if isinstance(seq, (tuple, list, np.ndarray)):
            enc, dec = int(seq[0]), int(seq[1])
        else:
            enc, dec = int(seq), 0
        return enc, dec

    def stage_fwd_time(self, mbs: int, seq, tp: int = 1) -> float:
        enc, dec = self._norm_seq(seq)
        mbs = _mxu_pad(int(mbs))
        layers = self.cfg.n_layers / self.n_stages
        fl = self._mean_layer(self._layer_flops_per_seq, mbs, enc)
        by = self._mean_layer(self._layer_bytes_per_seq, mbs, enc)
        if dec:
            fl += self._mean_layer(self._layer_flops_per_seq, mbs, dec) * 1.5
            by += self._mean_layer(self._layer_bytes_per_seq, mbs, dec) * 1.5
        fl, by = fl * layers / tp, by * layers / tp
        t = max(fl / (self.hw.peak_flops * self.hw.efficiency),
                by / (self.hw.hbm_bw * self.hw.efficiency))
        return (t + self.hw.per_op_overhead) * self.fwd_scale

    def stage_bwd_time(self, mbs: int, seq, tp: int = 1) -> float:
        return self.bwd_scale * (self.bwd_mult
                                 * (2.0 * self.stage_fwd_time(mbs, seq, tp)))

    def stage_act_memory(self, mbs: int, seq, tp: int = 1) -> float:
        enc, dec = self._norm_seq(seq)
        cfg = self.cfg
        layers = cfg.n_layers / self.n_stages
        tokens = mbs * (enc + dec)
        per_layer = {"full": 2.0, "selective": 8.0, "none": 20.0}[self.remat]
        return tokens * cfg.d_model * 2 * per_layer * layers / tp

    # ------------------------- batched interface ------------------------
    # Vectorized mirrors of the scalar roofline. Every expression keeps the
    # scalar code's evaluation order so the float64 results are bit-identical
    # (all integer partial products stay below 2^53 at sane model sizes).
    def _layer_flops_batch(self, mbs, t, spec):
        cfg = self.cfg
        d = cfg.d_model
        fl = 0.0
        if spec.mixer.startswith("attn"):
            h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
            fl = fl + 2 * t * d * (h * dh)
            fl = fl + 2 * 2 * t * d * (kv * dh)
            fl = fl + 2 * t * (h * dh) * d
            eff_ctx = t / 2
            if spec.mixer == "attn_local" and cfg.window:
                # guard the division for t == 0 rows (masked-out dec side)
                local = (cfg.window / 2
                         + (t - cfg.window) * cfg.window / np.maximum(t, 1))
                eff_ctx = np.where(t > cfg.window, local, eff_ctx)
            if not cfg.causal:
                eff_ctx = t
            fl = fl + 2 * 2 * t * eff_ctx * (h * dh)
        elif spec.mixer == "mamba":
            di, g, n, hh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            fl = fl + 2 * t * d * (2 * di + 2 * g * n + hh)
            fl = fl + 2 * t * (di + 2 * g * n) * cfg.ssm_conv
            chunk = np.minimum(128, t)
            p = cfg.ssm_headdim
            fl = fl + 2 * t * hh * (chunk * n + chunk * p + 2 * n * p)
            fl = fl + 2 * t * di * d
        if spec.moe:
            mult = 3 if cfg.mlp_gated else 2
            k_active = cfg.top_k * cfg.capacity_factor + cfg.n_shared_experts
            fl = fl + 2 * t * d * cfg.d_ff_expert * mult * k_active
            fl = fl + 2 * t * d * cfg.n_experts
        elif cfg.d_ff:
            mult = 3 if cfg.mlp_gated else 2
            fl = fl + 2 * t * d * cfg.d_ff * mult
        return mbs * fl

    def _layer_bytes_batch(self, mbs, t, spec):
        cfg = self.cfg
        d = cfg.d_model
        wbytes = 0.0
        if spec.mixer.startswith("attn"):
            wbytes = wbytes + 2 * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
                                   + cfg.n_heads * cfg.d_head * d)
        elif spec.mixer == "mamba":
            di, g, n, hh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            wbytes = wbytes + 2 * (d * (2 * di + 2 * g * n + hh) + di * d)
        if spec.moe:
            mult = 3 if cfg.mlp_gated else 2
            act_e = np.minimum(cfg.n_experts, mbs * t * cfg.top_k)
            wbytes = wbytes + 2 * mult * d * cfg.d_ff_expert * (act_e + cfg.n_shared_experts)
        elif cfg.d_ff:
            mult = 3 if cfg.mlp_gated else 2
            wbytes = wbytes + 2 * mult * d * cfg.d_ff
        abytes = 2 * mbs * t * d * 6
        return wbytes + abytes

    def _mean_layer_batch(self, fn, mbs, t):
        total = 0.0
        for spec in self.cfg.layer_pattern:
            total = total + fn(mbs, t, spec)
        return total / len(self.cfg.layer_pattern)

    def stage_times_batch(self, mbs, seq, tp: int = 1):
        m, enc, dec = _norm_seq_batch(mbs, seq)
        # evaluate once per distinct (mbs, enc, dec), then gather
        mu, encu, decu, inv = unique_shape_triples(m, enc, dec)
        mpad = np.maximum(8, -(-mu // 8) * 8).astype(np.float64)
        encf = encu.astype(np.float64)
        decf = decu.astype(np.float64)
        layers = self.cfg.n_layers / self.n_stages
        fl = self._mean_layer_batch(self._layer_flops_batch, mpad, encf)
        by = self._mean_layer_batch(self._layer_bytes_batch, mpad, encf)
        has_dec = decu > 0
        if has_dec.any():
            fl = fl + np.where(has_dec,
                               self._mean_layer_batch(self._layer_flops_batch,
                                                      mpad, decf) * 1.5, 0.0)
            by = by + np.where(has_dec,
                               self._mean_layer_batch(self._layer_bytes_batch,
                                                      mpad, decf) * 1.5, 0.0)
        fl, by = fl * layers / tp, by * layers / tp
        tf = np.maximum(fl / (self.hw.peak_flops * self.hw.efficiency),
                        by / (self.hw.hbm_bw * self.hw.efficiency))
        tf = (tf + self.hw.per_op_overhead) * self.fwd_scale
        tb = self.bwd_scale * (self.bwd_mult * (2.0 * tf))
        tokens = (mu * (encu + decu)).astype(np.float64)
        per_layer = {"full": 2.0, "selective": 8.0, "none": 20.0}[self.remat]
        mem = tokens * self.cfg.d_model * 2 * per_layer * layers / tp
        return tf[inv], tb[inv], mem[inv]


class ProfiledCostModel(CostModel):
    """Power-of-two grid + bilinear interpolation in log2 space (paper §3)."""

    def __init__(self, mbs_grid, seq_grid, fwd_t, bwd_t, mem):
        """fwd_t/bwd_t/mem: arrays (len(mbs_grid), len(seq_grid))."""
        self.mbs_grid = np.asarray(mbs_grid, dtype=np.float64)
        self.seq_grid = np.asarray(seq_grid, dtype=np.float64)
        self.fwd_t = np.asarray(fwd_t, dtype=np.float64)
        self.bwd_t = np.asarray(bwd_t, dtype=np.float64)
        self.mem = np.asarray(mem, dtype=np.float64)
        # pre-log the grids once — every interpolation (scalar or batched)
        # reads these instead of recomputing np.log2(grid) per call
        self._log2_mbs_grid = np.log2(self.mbs_grid)
        self._log2_seq_grid = np.log2(self.seq_grid)
        # learned calibration on top of the offline profile (CostModel.update)
        # — the profile ages (thermal drift, new machine) and the EMA scales
        # track the measured/profiled ratio without re-profiling
        self.fwd_scale = 1.0
        self.bwd_scale = 1.0

    @classmethod
    def profile(cls, measure, mbs_grid=(1, 2, 4, 8), seq_grid=(32, 64, 128, 256)):
        """measure(mbs, seq) -> (fwd_s, bwd_s, mem_bytes); fills the table."""
        fwd = np.zeros((len(mbs_grid), len(seq_grid)))
        bwd = np.zeros_like(fwd)
        mem = np.zeros_like(fwd)
        for i, m in enumerate(mbs_grid):
            for j, s in enumerate(seq_grid):
                fwd[i, j], bwd[i, j], mem[i, j] = measure(int(m), int(s))
        return cls(mbs_grid, seq_grid, fwd, bwd, mem)

    def _interp_batch(self, table, mbs, seqn) -> np.ndarray:
        """Vectorized log2 bilinear (extrapolating) blend; mbs/seqn float64."""
        lx = np.log2(np.maximum(mbs, 1e-9))
        ly = np.log2(np.maximum(seqn, 1e-9))
        gx = self._log2_mbs_grid
        gy = self._log2_seq_grid
        i = np.clip(np.searchsorted(gx, lx) - 1, 0, len(gx) - 2)
        j = np.clip(np.searchsorted(gy, ly) - 1, 0, len(gy) - 2)
        tx = np.clip((lx - gx[i]) / (gx[i + 1] - gx[i]), 0.0, None)
        ty = np.clip((ly - gy[j]) / (gy[j + 1] - gy[j]), 0.0, None)
        v00, v01 = table[i, j], table[i, j + 1]
        v10, v11 = table[i + 1, j], table[i + 1, j + 1]
        v0 = v00 + (v01 - v00) * ty
        v1 = v10 + (v11 - v10) * ty
        return np.maximum(v0 + (v1 - v0) * tx, 0.0)

    def _interp(self, table, mbs, seq) -> float:
        # scalar path = batch of one, so both are bit-identical by construction
        return float(self._interp_batch(table, np.asarray([mbs], dtype=np.float64),
                                        np.asarray([seq], dtype=np.float64))[0])

    def _norm_seq(self, seq) -> float:
        if isinstance(seq, (tuple, list, np.ndarray)):
            return float(seq[0]) + 1.5 * float(seq[1])
        return float(seq)

    def stage_fwd_time(self, mbs, seq, tp: int = 1) -> float:
        return self._interp(self.fwd_t, mbs, self._norm_seq(seq)) / tp \
            * self.fwd_scale

    def stage_bwd_time(self, mbs, seq, tp: int = 1) -> float:
        return self._interp(self.bwd_t, mbs, self._norm_seq(seq)) / tp \
            * self.bwd_scale

    def stage_act_memory(self, mbs, seq, tp: int = 1) -> float:
        return self._interp(self.mem, mbs, self._norm_seq(seq)) / tp

    def stage_times_batch(self, mbs, seq, tp: int = 1):
        m, enc, dec = _norm_seq_batch(mbs, seq)
        mf = m.astype(np.float64)
        seqn = enc.astype(np.float64) + 1.5 * dec.astype(np.float64)
        tf = self._interp_batch(self.fwd_t, mf, seqn) / tp * self.fwd_scale
        tb = self._interp_batch(self.bwd_t, mf, seqn) / tp * self.bwd_scale
        mem = self._interp_batch(self.mem, mf, seqn) / tp
        return tf, tb, mem


class OnlineCalibrator:
    """Feeds measured stage timings back into a cost model's learned scales.

    Wraps ``cost.update`` with the two things a raw EMA gets wrong online:

    - **compile warm-up**: the first observation of each (mbs, seq) shape is
      dominated by JIT compilation — skipped (``warmup`` observations per
      shape) so compile time never leaks into the plan costs;
    - **fwd/bwd attribution**: the sequential runner path only measures one
      fused grad-step time; :meth:`observe_total` splits it by the model's
      current predicted fwd:bwd ratio so both scales stay anchored.

    ``summary()`` reports the learned scales plus prediction error before and
    after calibration, which the tests and ``bench_elastic`` assert shrinks.
    """

    def __init__(self, cost: CostModel, ema: float = 0.25, warmup: int = 1):
        self.cost = cost
        self.ema = ema
        self.warmup = warmup
        self._seen: dict = {}
        self.n_observed = 0
        self.n_skipped = 0
        self._first_err: dict = {}   # shape -> |log(pred/meas)| at first obs
        self._last_err: dict = {}

    @staticmethod
    def _key(mbs, seq):
        if isinstance(seq, (tuple, list, np.ndarray)):
            return (int(mbs), int(seq[0]), int(seq[1]))
        return (int(mbs), int(seq), 0)

    def _record_err(self, key, mbs, seq, meas_s):
        pred = self.cost.stage_fwd_time(mbs, seq) + self.cost.stage_bwd_time(mbs, seq)
        if pred > 0.0 and meas_s > 0.0:
            err = abs(float(np.log(pred / meas_s)))
            self._first_err.setdefault(key, err)
            self._last_err[key] = err

    def observe(self, mbs: int, seq, fwd_s=None, bwd_s=None) -> bool:
        """One measured stage timing; returns True if it updated the model."""
        key = self._key(mbs, seq)
        n = self._seen.get(key, 0)
        self._seen[key] = n + 1
        if n < self.warmup:
            self.n_skipped += 1
            return False
        total = (fwd_s or 0.0) + (bwd_s or 0.0)
        self._record_err(key, mbs, seq, total)
        self.cost.update(mbs, seq, fwd_s=fwd_s, bwd_s=bwd_s, ema=self.ema)
        self.n_observed += 1
        return True

    def observe_total(self, mbs: int, seq, total_s: float) -> bool:
        """Fused fwd+bwd measurement, split by the predicted fwd:bwd ratio."""
        pf = self.cost.stage_fwd_time(mbs, seq)
        pb = self.cost.stage_bwd_time(mbs, seq)
        frac = pf / (pf + pb) if (pf + pb) > 0.0 else 1.0 / 3.0
        return self.observe(mbs, seq, fwd_s=total_s * frac,
                            bwd_s=total_s * (1.0 - frac))

    def summary(self) -> dict:
        firsts = list(self._first_err.values())
        lasts = list(self._last_err.values())
        return {
            **self.cost.scales(),
            "n_observed": self.n_observed,
            "n_skipped": self.n_skipped,
            "err_first": float(np.mean(firsts)) if firsts else None,
            "err_last": float(np.mean(lasts)) if lasts else None,
        }

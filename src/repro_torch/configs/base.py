"""Architecture & shape configuration system.

Every assigned architecture is a ``configs/<id>.py`` exporting ``CONFIG``
(an :class:`ArchConfig` with the exact published dimensions) and registered
in :data:`REGISTRY` here. Shapes (the assignment's 4 input-shape cells) are
:class:`ShapeSpec` entries in :data:`SHAPES`.

Design notes
------------
- Models are pure-JAX pytrees; the config fully determines parameter shapes.
- ``layer_pattern`` is a tuple of :class:`LayerSpec` repeated cyclically over
  ``n_layers`` — this is what lets us scan-over-periods for 80-layer models
  while supporting heterogeneous stacks (jamba's 1:7 mamba:attn interleave,
  gemma2's local/global alternation).
- ``vocab_padded`` rounds the embedding table up to a multiple of 256 so the
  vocab dim is always evenly shardable over a 16-way model axis and
  MXU-aligned; the loss masks the padded logits to -inf.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

VOCAB_ALIGN = 256


@dataclass(frozen=True)
class LayerSpec:
    """One layer in the (cyclic) stack pattern."""

    mixer: str = "attn"      # "attn" | "attn_local" | "mamba"
    moe: bool = False        # MoE FFN instead of dense FFN


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""         # provenance note ([arXiv/hf; tier])

    # trunk dims
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0            # dense-FFN hidden size (0 = no dense FFN)
    vocab: int = 0

    # stack pattern (repeated cyclically; len must divide n_layers)
    layer_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    # attention details
    use_rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None    # gemma2 attention logit soft-capping
    final_softcap: Optional[float] = None   # gemma2 final-logit soft-capping
    window: int = 0                          # sliding window for "attn_local"
    causal: bool = True                      # False => encoder-only (hubert)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0                # llama4 shared expert
    capacity_factor: float = 1.25

    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1

    # I/O & head
    input_mode: str = "tokens"  # tokens | frames (audio) | mixed (vlm)
    n_patches: int = 0          # vlm: precomputed patch embeddings prepended
    tie_embeddings: bool = False
    scale_embed: bool = False   # gemma: h *= sqrt(d_model) after lookup
    decode: bool = True         # encoder-only archs have no decode step
    subquadratic: bool = False  # eligible for long_500k
    norm_eps: float = 1e-6
    mlp_gated: bool = True
    act: str = "silu"
    dtype: str = "bfloat16"
    # ZeRO-3/FSDP: shard the bf16 compute params over the data axis too and
    # gather per layer — required when params·2B/tp exceeds HBM (>= ~100B).
    fsdp_params: bool = False
    # Unroll the scan-over-periods (few-period archs, e.g. jamba's 9 x 8
    # layers): lets GSPMD keep per-leaf grad shardings instead of a stacked
    # while-carry accumulator that loses the tp/zero dims.
    unroll_stack: bool = False
    # --- perf-hillclimb knobs (EXPERIMENTS.md §Perf) ---
    # Replicate attention projection weights over the model axis (kills the
    # per-layer k/v gathers; sensible when attn params are small, e.g. <=2B
    # models with fat vocabularies like gemma2).
    attn_tp: bool = True
    # Zero-pad the q-head count up to a multiple of the model axis INSIDE the
    # forward (constant pads; outputs exactly unchanged) so attention runs
    # head-parallel even for uneven head counts (40H/56H on a 16-way axis).
    pad_heads: bool = False
    # activation-checkpoint policy for the period scan:
    # "nothing" (full remat) | "dots" (save matmul outputs) | "everything"
    remat_policy: str = "nothing"
    # Small-model mode: the model axis becomes extra DP (weights replicated,
    # ZeRO over data x model) — see dist.sharding.pure_dp.
    pure_dp: bool = False

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + VOCAB_ALIGN - 1) // VOCAB_ALIGN) * VOCAB_ALIGN

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def pattern_layers(self) -> tuple[LayerSpec, ...]:
        """The full, n_layers-long expanded pattern."""
        period = len(self.layer_pattern)
        assert self.n_layers % period == 0, (self.name, self.n_layers, period)
        reps = self.n_layers // period
        return tuple(self.layer_pattern) * reps

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def has_attn(self) -> bool:
        return any(l.mixer.startswith("attn") for l in self.layer_pattern)

    @property
    def has_mamba(self) -> bool:
        return any(l.mixer == "mamba" for l in self.layer_pattern)

    @property
    def has_moe(self) -> bool:
        return any(l.moe for l in self.layer_pattern)

    # ---------------------------- parameter counting -------------------
    def param_counts(self) -> dict[str, int]:
        """Exact parameter counts by component (used for 6·N·D roofline)."""
        d = self.d_model
        counts: dict[str, int] = {}
        counts["embed"] = self.vocab_padded * d
        if not self.tie_embeddings and self.input_mode != "frames":
            counts["lm_head"] = self.vocab_padded * d
        if self.input_mode == "frames":
            counts["cls_head"] = self.vocab_padded * d
        per_layer_attn = (
            d * self.n_heads * self.d_head          # wq
            + 2 * d * self.n_kv_heads * self.d_head  # wk, wv
            + self.n_heads * self.d_head * d          # wo
        )
        if self.qkv_bias:
            per_layer_attn += (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        mlp_mult = 3 if self.mlp_gated else 2
        per_layer_mlp = mlp_mult * d * self.d_ff
        per_layer_moe = (
            self.n_experts * mlp_mult * d * self.d_ff_expert
            + self.n_shared_experts * mlp_mult * d * self.d_ff_expert
            + d * self.n_experts  # router
        )
        if self.has_mamba:
            di, g, s, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            conv_ch = di + 2 * g * s
            per_layer_mamba = (
                d * (2 * di + 2 * g * s + h)  # in_proj -> [z, x, B, C, dt]
                + conv_ch * self.ssm_conv      # depthwise conv
                + h                              # A_log
                + h                              # dt bias
                + di                             # D skip
                + di * d                         # out_proj
                + di                             # gated norm
            )
        else:
            per_layer_mamba = 0
        attn_l = mamba_l = moe_l = mlp_l = 0
        for spec in self.pattern_layers:
            if spec.mixer.startswith("attn"):
                attn_l += 1
            elif spec.mixer == "mamba":
                mamba_l += 1
            if spec.moe:
                moe_l += 1
            elif self.d_ff:
                mlp_l += 1
        counts["attn"] = attn_l * per_layer_attn
        counts["mamba"] = mamba_l * per_layer_mamba
        counts["moe"] = moe_l * per_layer_moe
        counts["mlp"] = mlp_l * per_layer_mlp
        counts["norms"] = self.n_layers * 2 * d + d
        return counts

    def n_params(self) -> int:
        return sum(self.param_counts().values())

    def n_params_active(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.has_moe:
            return self.n_params()
        total = self.n_params()
        mlp_mult = 3 if self.mlp_gated else 2
        moe_layers = sum(1 for s in self.pattern_layers if s.moe)
        full = self.n_experts * mlp_mult * self.d_model * self.d_ff_expert
        active = (self.top_k + self.n_shared_experts) * mlp_mult * self.d_model * self.d_ff_expert
        return total - moe_layers * (full - active)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
ARCH_IDS = [
    "jamba-1.5-large-398b",
    "gemma2-2b",
    "starcoder2-7b",
    "qwen2.5-32b",
    "qwen1.5-110b",
    "mamba2-130m",
    "granite-moe-3b-a800m",
    "llama4-scout-17b-a16e",
    "llava-next-34b",
    "hubert-xlarge",
    # the paper's own models (benchmark analogues, not assignment cells)
    "gpt-paper",
    "t5-paper",
]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    period = len(cfg.layer_pattern)
    n_layers = period if period > 1 else 2
    d_head = 16
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads else 0
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads if cfg.n_heads else 0,
        n_kv_heads=n_kv,
        d_head=d_head if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_shared_experts=cfg.n_shared_experts,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        window=min(cfg.window, 32) if cfg.window else 0,
        n_patches=8 if cfg.n_patches else 0,
    )


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch × shape) assignment cell is runnable (see DESIGN §6)."""
    if shape.kind == "decode" and not cfg.decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
    if shape.kind == "prefill" and not cfg.decode:
        # encoder-only prefill == full encode forward; allowed.
        return True, "encoder-only: prefill == full encode forward"
    return True, ""


def all_cells() -> list[tuple[str, str, bool, str]]:
    """(arch, shape, runnable, reason) for the 10×4 assignment grid."""
    out = []
    for arch in ARCH_IDS[:10]:
        cfg = get_arch(arch)
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out

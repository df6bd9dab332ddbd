"""Gemma 2 2B: dense, local/global alternating attention, logit soft-capping.

[arXiv:2408.00118 + hf google/gemma-2-2b; hf-verified]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    source="[arXiv:2408.00118; hf]",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab=256000,
    # gemma2 alternates sliding-window (local) and full (global) attention.
    # 26 layers = 13 repeats of (local, global).
    layer_pattern=(LayerSpec("attn_local"), LayerSpec("attn")),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    scale_embed=True,
    rope_theta=10_000.0,
    mlp_gated=True,
    act="gelu",
    subquadratic=False,       # global layers are full attention -> long_500k skipped
)

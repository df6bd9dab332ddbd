"""LLaVA-NeXT-34B: VLM — Yi-34B language backbone + anyres vision tiling.

[hf llava-hf/llava-v1.6-34b-hf; unverified]
Per assignment, only the transformer BACKBONE is modeled; the vision tower is
a stub: input_specs() supplies precomputed patch embeddings (anyres tiling
of 4 tiles + base image at 576 patches each = 2880 patch positions) that the
model prepends to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    layer_pattern=(LayerSpec("attn"),),
    rope_theta=5_000_000.0,
    input_mode="mixed",
    n_patches=2880,
    mlp_gated=True,
    act="silu",
)

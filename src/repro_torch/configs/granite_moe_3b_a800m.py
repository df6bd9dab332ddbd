"""Granite-3.0-3B-A800M: fine-grained MoE, 40 experts top-8, tiny expert FFN.

[hf ibm-granite/granite-3.0-3b-a800m-base (family verified via 1b-a400m); hf]
Every layer is MoE (no dense FFN). 40 experts do not divide the 16-way model
axis, so experts use internal tensor parallelism (see DESIGN §5/§6).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,
    d_ff_expert=512,
    vocab=49155,
    layer_pattern=(LayerSpec("attn", moe=True),),
    n_experts=40,
    top_k=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
    mlp_gated=True,
    act="silu",
)

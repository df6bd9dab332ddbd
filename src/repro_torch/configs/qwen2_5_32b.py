"""Qwen2.5-32B: dense GQA with QKV bias.

[hf Qwen/Qwen2.5-32B (family config verified via Qwen/Qwen2.5-0.5B); hf]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=27648,
    vocab=152064,
    layer_pattern=(LayerSpec("attn"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_gated=True,
    act="silu",
)

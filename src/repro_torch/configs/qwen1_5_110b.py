"""Qwen1.5-110B: dense GQA with QKV bias — the largest dense arch in the pool.

[hf Qwen/Qwen1.5-110B (family config verified via Qwen/Qwen1.5-0.5B); hf]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    fsdp_params=True,
    name="qwen1.5-110b",
    family="dense",
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab=152064,
    layer_pattern=(LayerSpec("attn"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_gated=True,
    act="silu",
)

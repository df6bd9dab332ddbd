"""Mamba2-130m: attention-free SSM with SSD (state-space duality) mixers.

[arXiv:2405.21060; unverified]
d_inner = 2*768 = 1536, headdim 64 => 24 SSD heads, d_state 128.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,                   # pure mamba blocks, no FFN
    vocab=50280,
    layer_pattern=(LayerSpec("mamba"),),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    tie_embeddings=True,
    use_rope=False,
    subquadratic=True,
)

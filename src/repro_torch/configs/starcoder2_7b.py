"""StarCoder2-7B: dense GQA + RoPE code model.

[arXiv:2402.19173 + hf bigcode/starcoder2-7b; hf-verified]
StarCoder2 uses non-gated GELU MLP and bias terms on QKV.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    source="[arXiv:2402.19173; hf]",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_head=128,
    d_ff=18432,
    vocab=49152,
    layer_pattern=(LayerSpec("attn"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_gated=False,
    act="gelu",
)

"""The paper's GPT model (Table 1, 8-GPU column: 32L/4096/32H, 6.7B).

Used by the paper-validation benchmarks (Fig. 13-18 analogues), not an
assignment cell.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gpt-paper",
    family="dense",
    source="[DynaPipe Table 1; paper]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=16384,
    vocab=50304,
    layer_pattern=(LayerSpec("attn"),),
    rope_theta=10_000.0,
    mlp_gated=False,
    act="gelu",
)

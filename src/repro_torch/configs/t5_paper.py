"""The paper's T5 model (Table 1, 8-GPU column: 24+24L, d=1024, 128H, ffn 65536 ~ 11B).

Encoder-decoder: the micro-batch DP sorts on the (input_len, target_len) pair
(paper §4 "Determine the order of samples"). Used by paper-validation
benchmarks, not an assignment cell. ``n_layers`` counts encoder layers; the
decoder mirrors it (paper: "# layers refers to layers present in both").
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="t5-paper",
    family="encdec",
    source="[DynaPipe Table 1; paper]",
    n_layers=24,
    d_model=1024,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=65536,
    vocab=32128,
    layer_pattern=(LayerSpec("attn"),),
    rope_theta=10_000.0,
    mlp_gated=False,
    act="relu",
)

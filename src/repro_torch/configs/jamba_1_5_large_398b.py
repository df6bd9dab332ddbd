"""Jamba-1.5-Large (398B total / ~94B active): hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887 + hf ai21labs/AI21-Jamba-1.5-Large; hf-verified]
Period-8 pattern: attention at layer index 4 of each period, MoE on every
other layer (odd indices) — matching Jamba's published interleave.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

_PERIOD = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ArchConfig(
    fsdp_params=True,
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="[arXiv:2403.19887; hf]",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    d_ff_expert=24576,
    vocab=65536,
    layer_pattern=_PERIOD,
    n_experts=16,
    top_k=2,
    ssm_state=128,
    ssm_headdim=128,
    ssm_expand=2,
    ssm_conv=4,
    use_rope=False,           # jamba uses no positional embedding (positions carried by SSM layers)
    subquadratic=True,        # 1:7 mamba:attn => KV cache only on 1/8 layers; long_500k runnable
    mlp_gated=True,
    act="silu",
)

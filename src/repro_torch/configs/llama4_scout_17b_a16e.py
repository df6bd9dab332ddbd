"""Llama-4-Scout-17B-16E: MoE (16 routed experts, top-1, + 1 shared expert).

[hf meta-llama/Llama-4-Scout-17B-16E; unverified]
Assignment specifies the text backbone (early-fusion frontend out of scope;
multimodality is carried by the llava-next-34b [vlm] cell).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    fsdp_params=True,
    name="llama4-scout-17b-a16e",
    family="moe",
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    d_ff_expert=8192,
    vocab=202048,
    layer_pattern=(LayerSpec("attn", moe=True),),
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    rope_theta=500_000.0,
    mlp_gated=True,
    act="silu",
)

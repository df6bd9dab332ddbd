"""HuBERT X-Large: encoder-only audio transformer (wav2vec2-style backbone).

[arXiv:2106.07447; unverified]
Per assignment, the conv feature-extractor frontend is a STUB: input_specs()
supplies precomputed frame embeddings (B, S, d_model). The head predicts the
504 masked-unit targets. Encoder-only => no decode shapes (see DESIGN §6).
Positional information: the conv-positional frontend is part of the stub; the
backbone here uses RoPE as the TPU-idiomatic stand-in (documented deviation).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    source="[arXiv:2106.07447; unverified]",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab=504,
    layer_pattern=(LayerSpec("attn"),),
    causal=False,
    decode=False,
    input_mode="frames",
    mlp_gated=False,
    act="gelu",
    norm_eps=1e-5,
)

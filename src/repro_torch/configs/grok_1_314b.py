"""grok-1-314b — xAI Grok-1 MoE, 8 experts top-2.

[hf:xai-org/grok-1; unverified]  Assigned config: 64L d_model=6144 48H
(GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2. 314B total / ~86B active.
Largest assigned model -> FSDP parameter sharding is mandatory.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    pattern_groups=((("moe",), 64),),
    head_dim=128,
    n_experts=8,
    top_k=2,
    tie_embeddings=True,
    source="hf:xai-org/grok-1",
))

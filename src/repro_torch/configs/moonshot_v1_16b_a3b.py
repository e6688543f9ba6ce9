"""moonshot-v1-16b-a3b — kimi/moonlight-style MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  Assigned config: 48L d_model=2048
16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840, MoE 64e top-6.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    pattern_groups=((("moe",), 48),),
    head_dim=128,
    n_experts=64,
    top_k=6,
    tie_embeddings=True,
    source="hf:moonshotai/Moonlight-16B-A3B",
))

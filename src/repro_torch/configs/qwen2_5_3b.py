"""qwen2.5-3b — dense GQA kv=2, QKV bias.

[hf:Qwen/Qwen2.5-0.5B (family); hf]  Assigned config: 36L d_model=2048
16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11_008,
    vocab=151_936,
    pattern_groups=((("global",), 36),),
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-3B",
))

"""stablelm-1.6b — dense MHA (kv = heads).

[hf:stabilityai/stablelm-2-1_6b; unverified]  Assigned config: 24L
d_model=2048 32H (GQA kv=32 == MHA) d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5_632,
    vocab=100_352,
    pattern_groups=((("global",), 24),),
    head_dim=64,
    tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
))

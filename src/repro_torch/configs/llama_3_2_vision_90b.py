"""llama-3.2-vision-90b — VLM: cross-attention image layers every 5th layer.

[hf:meta-llama/Llama-3.2-11B-Vision (family); unverified]  Assigned config:
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The vision
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings (frontend_tokens x d_model); the backbone's cross-attn
layers attend to them. 100 = 20 x (4 self + 1 cross).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=128_256,
    pattern_groups=(
        (("global", "global", "global", "global", "cross"), 20),
    ),
    head_dim=128,
    frontend_tokens=1_024,
    tie_embeddings=False,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-90B-Vision",
))

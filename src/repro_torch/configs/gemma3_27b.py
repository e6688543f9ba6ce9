"""gemma3-27b — dense, 5:1 local:global attention interleave, 128k context.

[hf:google/gemma-3-1b-pt (family); unverified]  Assigned config: 62L
d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; 5 sliding-window
layers per global layer (window 1024). 62 = 10 x (5 local + 1 global) + 2.

long_500k RUNS for this arch: only the 10 global layers keep full-context
KV (sharded over the sequence); the 52 local layers keep a 1024-token ring.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21_504,
    vocab=262_144,
    pattern_groups=(
        (("local", "local", "local", "local", "local", "global"), 10),
        (("local", "local"), 1),
    ),
    head_dim=128,
    window=1024,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-27b-pt",
))

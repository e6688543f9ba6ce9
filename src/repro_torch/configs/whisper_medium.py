"""whisper-medium — encoder-decoder; conv audio frontend is a STUB.

[arXiv:2212.04356; unverified]  Assigned config: 24L d_model=1024 16H
(kv=16) d_ff=4096 vocab=51865. Backbone only: input_specs() provides the
1500 precomputed frame embeddings (post-conv-stem stub); we implement the
24-layer bidirectional encoder + 24-layer (self+cross) decoder.

long_500k is SKIPPED: the decoder context is architecturally bounded by the
30 s / 1500-frame encoder window.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                       # decoder depth (encoder: enc_layers)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4_096,
    vocab=51_865,
    pattern_groups=((("selfcross",), 24),),
    head_dim=64,
    enc_layers=24,
    frontend_tokens=1_500,
    tie_embeddings=True,
    source="arXiv:2212.04356",
))

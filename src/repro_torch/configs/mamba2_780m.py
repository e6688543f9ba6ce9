"""mamba2-780m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]  Assigned config: 48L d_model=1536
(attn-free, d_ff=0) vocab=50280, ssm_state=128. expand=2 -> d_inner=3072,
head_dim=64 -> 48 value heads.

long_500k RUNS: decode state is O(1) in sequence length.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    pattern_groups=((("ssd",), 48),),
    ssm_state=128,
    ssm_heads=48,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.21060",
))

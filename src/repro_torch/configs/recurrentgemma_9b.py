"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; unverified]  Assigned config: 38L d_model=4096 16H
(MQA kv=1) d_ff=12288 vocab=256000. Block pattern per Griffin: two
recurrent (RG-LRU) blocks per local-attention block; 38 = 12 x (R,R,A) + 2.

long_500k RUNS: recurrent state is O(1) in sequence length and the
attention layers keep only a 2048-token window.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12_288,
    vocab=256_000,
    pattern_groups=(
        (("rglru", "rglru", "local"), 12),
        (("rglru", "rglru"), 1),
    ),
    head_dim=256,
    window=2_048,
    rnn_width=4_096,
    tie_embeddings=True,
    source="arXiv:2402.19427",
))

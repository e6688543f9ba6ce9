"""Deterministic synthetic data: the ``uniform`` generator of
``repro/data/pipeline.py``.

Every batch is a pure function of (seed, step), drawn from a CPU
``torch.Generator``. That cannot reproduce ``jax.random``'s threefry
values, so a test that compares the two packages passes its tokens
explicitly. The ``bigram`` chain comes with the train step (ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    kind: str = "uniform"        # the reference's "bigram" is not ported


def make_batch(cfg: DataConfig, step: int) -> dict:
    """(seed, step) -> {"tokens": (B, S+1) int32}, on the CPU."""
    if cfg.kind != "uniform":
        raise NotImplementedError(
            f"data kind {cfg.kind!r} is not ported yet (ROADMAP: it comes "
            f"with the train step)")
    gen = torch.Generator().manual_seed((cfg.seed << 32) + step)
    toks = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len + 1),
                         generator=gen, dtype=torch.int32)
    return {"tokens": toks}

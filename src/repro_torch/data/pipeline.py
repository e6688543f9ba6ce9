"""Deterministic synthetic data pipeline: the port of
``repro/data/pipeline.py``.

Two generators:
  - ``uniform``: i.i.d. tokens (shape stand-ins, serving, the full-width
    train run);
  - ``bigram``: tokens sampled from a fixed random first-order Markov
    chain, so a model CAN learn it: the loss falls toward the chain's
    conditional entropy (``bigram_entropy``).

Every batch is a pure function of (seed, step), drawn from CPU
``torch.Generator``s. They cannot reproduce ``jax.random``'s threefry
values, so a test that compares the two packages passes its tokens, or
the transition table (``make_batch(..., logits=)``), across.

The transition table is vocab**2 fp32: 92 GB at qwen2.5-3b's 151 936
tokens, in both packages. ``bigram`` is for the reduced and small
configs; the full-width run takes ``uniform``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    kind: str = "bigram"         # "bigram" | "uniform"
    temperature: float = 0.7     # bigram sharpness (lower = more learnable)


@functools.lru_cache(maxsize=4)
def transition_logits(cfg: DataConfig) -> torch.Tensor:
    """The chain's (vocab, vocab) fp32 logits: N(0, 1) / temperature, from
    the seed (the reference's ``_transition_logits``, with other values)."""
    gen = torch.Generator().manual_seed(cfg.seed ^ 0x5EED)
    return torch.randn((cfg.vocab, cfg.vocab), generator=gen) \
        / cfg.temperature


@functools.lru_cache(maxsize=4)
def transition_probs(cfg: DataConfig) -> torch.Tensor:
    """The chain's (vocab, vocab) fp32 transition probabilities, the
    softmax of ``transition_logits``: computed once a chain, not once a
    batch (a 67 M-element softmax at vocab 8 192)."""
    return torch.softmax(transition_logits(cfg), dim=-1)


def _probs(cfg: DataConfig, logits) -> torch.Tensor:
    if logits is None:
        return transition_probs(cfg)
    return torch.softmax(torch.as_tensor(logits, dtype=torch.float32),
                         dim=-1)


def make_batch(cfg: DataConfig, step: int,
               logits: torch.Tensor | None = None) -> dict:
    """(seed, step) -> {"tokens": (B, S+1) int32}, on the CPU. ``logits``
    replaces the chain's transition logits (a test passes the reference's
    table across)."""
    gen = torch.Generator().manual_seed((cfg.seed << 32) + int(step))
    if cfg.kind == "uniform":
        toks = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len + 1),
                             generator=gen, dtype=torch.int32)
        return {"tokens": toks}
    if cfg.kind != "bigram":
        raise ValueError(f"data kind must be 'bigram' or 'uniform', got "
                         f"{cfg.kind!r}")
    probs = _probs(cfg, logits)
    tok = torch.randint(0, cfg.vocab, (cfg.batch,), generator=gen)
    rows = [tok]
    for _ in range(cfg.seq_len):
        tok = torch.multinomial(probs[tok], 1, generator=gen)[:, 0]
        rows.append(tok)
    return {"tokens": torch.stack(rows, dim=1).to(torch.int32)}


def bigram_entropy(cfg: DataConfig,
                   logits: torch.Tensor | None = None) -> float:
    """Mean conditional entropy of the chain (the loss floor)."""
    p = _probs(cfg, logits)
    h = -(p * torch.log(p.clamp(min=1e-30))).sum(dim=-1)
    return float(h.mean())


def add_modality_stubs(batch: dict, arch_cfg, batch_size: int,
                       seed: int = 0) -> dict:
    """Precomputed frame/patch embeddings (bf16 N(0, 1)) for the VLM and
    encoder-decoder families; a text model's batch is left as it is."""
    for want, key, salt in ((arch_cfg.family == "vlm", "patches", 0xB1D),
                            (arch_cfg.is_encdec, "frames", 0xA1D)):
        if want:
            gen = torch.Generator().manual_seed(seed ^ salt)
            batch[key] = torch.randn(
                (batch_size, arch_cfg.frontend_tokens, arch_cfg.d_model),
                generator=gen).to(torch.bfloat16)
    return batch


def shard_batch(batch: dict, device) -> dict:
    """Place a host batch on the device. One card holds the whole batch,
    so the reference's global sharding over the mesh is a copy."""
    return {k: v.to(device) for k, v in batch.items()}

"""AdamW on ZeRO-scattered leaves (mixed precision): the port of
``repro/optim/adamw.py``.

Optimizer state is fp32 (master, m, v) per parameter leaf; the bf16
parameter is rebuilt from the updated master. One card holds every leaf
whole, so a leaf's "scattered chunk" is the leaf. ``step`` is a Python int
or a 0-d tensor; the schedule and the bias corrections are computed in
fp32, as the reference computes them.

Every divide is by a tensor: PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal, which rounds differently.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``lr * min_lr_ratio``:
    a 0-d fp32 tensor."""
    s = _f32(step, device)
    warm = s / _f32(max(cfg.warmup_steps, 1), device)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              device), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_leaf_state(master: torch.Tensor) -> dict:
    """master: fp32 copy of one param leaf."""
    return {"master": master, "m": torch.zeros_like(master),
            "v": torch.zeros_like(master)}


def decay_mask(leaf: torch.Tensor) -> bool:
    return leaf.dim() >= 2      # no weight decay on norms/biases/scalars


def adamw_leaf(state: dict, grad: torch.Tensor, *, lr, cfg: AdamWConfig,
               step, wd_on: bool) -> dict:
    """One AdamW update of a leaf: the reference's arithmetic, operation
    for operation, in fp32. Unlike the reference, which returns new
    arrays, it writes m, v and master into the state's tensors and
    returns the state: a 311 M-element embedding's state is 3.7 GB, and
    the transients stay at a few leaf-sized buffers."""
    dev = grad.device
    g = grad.to(torch.float32)
    m, v, master = state["m"], state["v"], state["master"]
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
    del g
    t = _f32(step, dev) + 1.0
    c1 = 1 - torch.pow(_f32(cfg.b1, dev), t)
    c2 = 1 - torch.pow(_f32(cfg.b2, dev), t)
    upd = m / c1
    den = torch.sqrt(v / c2).add_(cfg.eps)
    upd.div_(den)
    del den
    if wd_on:
        upd.add_(master * cfg.weight_decay)
    master.sub_(upd.mul_(_f32(lr, dev)))
    return state


def global_norm_sq_local(grads_leaves: list[torch.Tensor]) -> torch.Tensor:
    """Sum of squares over this rank's (disjoint) scattered chunks."""
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in grads_leaves)


def clip_factor(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: ``scalar / tensor`` is a reciprocal times the
    # scalar in PyTorch, not a divide
    return torch.clamp(_f32(max_norm, gnorm.device)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)

"""Causal depthwise convolution of the recurrent mixers.

The port of the two helpers of ``repro/models/ssm.py`` that the RG-LRU
mixer (``models/rglru.py``) uses: ``causal_conv1d`` over a sequence and
``conv1d_step`` for one decode step. Both compute in fp32. The Mamba-2
mixer of that module (``ssd_chunked``, ``init_mamba2``, ``mamba2_train``,
``mamba2_decode``) comes with the ``ssd`` block, in a later slice of the
port (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (K,C) -> (B,S,C), fp32. The
    K terms are summed in the reference's order (tap 0 first)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    y = w[0] * xp[:, 0:s]
    for j in range(1, k):
        y = y + w[j] * xp[:, j:j + s]
    return y + b


def conv1d_step(window: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """window: (B,K,C) (oldest first, newest = current input) -> (B,C)."""
    return torch.einsum("bkc,kc->bc", window.float(), w) + b

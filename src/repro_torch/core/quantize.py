"""Fixed-point quantization with overflow fallback (paper §5.2.1).

The NetFilter `Precision` field gives the scaling factor 10**p. Values are
quantized to int32 fixed point for in-network accumulation; overflow anywhere
along the reduction surfaces as a sentinel, and the receiver re-computes
exactly the overflowed lanes in fp32 ("server agent" software fallback) so
the result is always correct — the paper's central reliability contract.

On the card ``quantize`` and ``dequantize`` are one kernel launch each
(``kernels/quantize.py``, ``kernels/dequantize.py``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import ops


def precision_scale(precision: int) -> float:
    """10**precision as the fp32 value the kernels compute with."""
    return float(np.float32(10.0 ** precision))


def quantize(x: torch.Tensor, precision: int) -> torch.Tensor:
    """fp32 -> int32 fixed point at 10**precision (any shape)."""
    return ops.quantize(x, precision_scale(precision))


def dequantize(q: torch.Tensor, precision: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 -> (fp32, overflow mask) at 10**precision (any shape)."""
    return ops.dequantize(q, precision_scale(precision))


def with_fallback(q_result: torch.Tensor, local_fp32: torch.Tensor,
                  precision: int,
                  fp32_reduce: Callable[[torch.Tensor], torch.Tensor],
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantize an INC reduction result and repair overflowed lanes.

    q_result:   int32 reduced values (sentinels mark overflow on some hop)
    local_fp32: this rank's original fp32 contribution, same shape
    fp32_reduce: the software-path reduction (e.g. an all-reduce over the
        DP axes) — the "resend to the server agent" of §5.2.1.

    Returns (fp32 result, overflow mask). Only overflowed lanes carry
    values into the fp32 re-reduction; the mask zeroes everything else.
    """
    x, mask = dequantize(q_result, precision)
    repaired = fp32_reduce(torch.where(mask, local_fp32,
                                       torch.zeros_like(local_fp32)))
    return torch.where(mask, repaired, x), mask

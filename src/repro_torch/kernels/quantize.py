"""Fixed-point quantize with sentinel saturation: the transmit side of
the SyncAgtr path (core/quantize.py).

``quantize(x, scale)``: fp32 (any shape) -> int32, ``round_half_even(x *
scale)`` in fp32, saturating to the MAX_INT/MIN_INT overflow sentinels.
On the card it is the hand-written kernel of ``csrc/quantize.cu``,
replacing ``repro/kernels/quantize.py:quantize_pallas``; a CPU tensor
takes the plain version (``ref.quantize``), a meta tensor (the dry run)
an empty int32 output and one record of the kernel's 8 bytes an element
(``backend.record_launch``). The stream is flat: the reference's padding
to (256, 128) TPU tiles has no counterpart here.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import backend, build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
SIGNATURES = {"repro_quantize": (_P, _I, _F, _P)}


def quantize_plain(x: torch.Tensor, scale) -> torch.Tensor:
    return ref.quantize(x, scale)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """x: contiguous fp32 (any shape) -> int32 of x's shape and device."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("quantize: x must be contiguous fp32")
    if x.device.type == "cpu":
        build.count(quantize, "plain_calls")
        return quantize_plain(x, scale)
    if x.device.type == "meta":
        # fp32 read once, int32 written once
        backend.record_launch("quantize", 8 * x.numel())
        return torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for {x.device.type} tensors")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        build.launch("quantize", SIGNATURES, "repro_quantize", x.data_ptr(),
                     x.numel(), float(np.float32(scale)), out.data_ptr())
    build.count(quantize)
    return out


quantize.launches = 0       # kernel launches on the card
quantize.plain_calls = 0    # CPU tensors sent to the plain version

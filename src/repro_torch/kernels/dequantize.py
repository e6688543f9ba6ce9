"""Fixed-point dequantize with the overflow mask: the receive side of the
SyncAgtr path (core/quantize.py).

``dequantize(q, scale)``: int32 (any shape) -> (fp32 ``q * (1 /
float32(scale))``, bool mask of the MAX_INT/MIN_INT sentinel lanes). The
value is a multiply by the fp32 reciprocal, never a divide, so it agrees
bit for bit with the reference. On the card it is the hand-written
kernel of ``csrc/dequantize.cu``, replacing
``repro/kernels/dequantize.py:dequantize_pallas``; a CPU tensor takes the
plain version (``ref.dequantize``), a meta tensor (the dry run) empty
outputs and one record of the kernel's 9 bytes an element
(``backend.record_launch``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import backend, build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
SIGNATURES = {"repro_dequantize": (_P, _I, _F, _P, _P)}


def dequantize_plain(q: torch.Tensor, scale
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.dequantize(q, scale)


def dequantize(q: torch.Tensor, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """q: contiguous int32 (any shape) -> (fp32, bool) of q's shape and
    device."""
    if q.dtype != torch.int32 or not q.is_contiguous():
        raise TypeError("dequantize: q must be contiguous int32")
    if q.device.type == "cpu":
        build.count(dequantize, "plain_calls")
        return dequantize_plain(q, scale)
    if q.device.type == "meta":
        # int32 read once, fp32 and the bool mask written once
        backend.record_launch("dequantize", 9 * q.numel())
        return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                torch.empty(q.shape, dtype=torch.bool, device=q.device))
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for {q.device.type} tensors")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    mask = torch.empty(q.shape, dtype=torch.bool, device=q.device)
    if q.numel() == 0:
        return out, mask
    inv = float(np.float32(1.0) / np.float32(scale))
    with torch.cuda.device(q.device):
        build.launch("dequantize", SIGNATURES, "repro_dequantize",
                     q.data_ptr(), q.numel(), inv, out.data_ptr(),
                     mask.data_ptr())
    build.count(dequantize)
    return out, mask


dequantize.launches = 0     # kernel launches on the card
dequantize.plain_calls = 0  # CPU tensors sent to the plain version

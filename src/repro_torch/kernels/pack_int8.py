"""Block-scaled int8 pack and unpack: the int8 wire format of
``ops.pack_int8`` / ``ops.unpack_int8``.

``pack_int8(x)``: fp32 (rows, 128) -> (int8 q (rows, 128), fp32 scale
(rows,)), one scale per 128-lane row: scale = max|row| / 127 (1 for a zero
row), q = round-half-even(x / scale) clipped to +-127. ``unpack_int8(q,
scale)``: q * scale[row] -> fp32 (rows, 128). On the card they are the
hand-written kernels of ``csrc/pack_int8.cu``, replacing
``repro/kernels/pack_int8.py:pack_int8_pallas`` and
``unpack_int8_pallas``; a CPU tensor takes the plain versions
(``ref.pack_int8_block`` / ``ref.unpack_int8_block``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.constants import LANES

_P, _I = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {"repro_pack_int8": (_P, _I, _P, _P),
              "repro_unpack_int8": (_P, _P, _I, _P)}


def pack_int8_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.pack_int8_block(x)


def unpack_int8_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return ref.unpack_int8_block(q, scale)


def _rows(t: torch.Tensor, dtype, what: str) -> int:
    if t.dtype != dtype or not t.is_contiguous() or t.dim() != 2 \
            or t.shape[1] != LANES:
        raise TypeError(f"{what} must be contiguous {dtype} (rows, {LANES})")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for {t.device.type} tensors")
    return t.shape[0]


def pack_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: contiguous fp32 (rows, 128) -> (int8 (rows, 128), fp32 (rows,))
    on x's device."""
    rows = _rows(x, torch.float32, "pack_int8: x")
    if x.device.type == "cpu":
        build.count(pack_int8, "plain_calls")
        return pack_int8_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("pack_int8: x must be 16-byte aligned")
    q = torch.empty((rows, LANES), dtype=torch.int8, device=x.device)
    scale = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    with torch.cuda.device(x.device):
        build.launch("pack_int8", SIGNATURES, "repro_pack_int8",
                     x.data_ptr(), rows, q.data_ptr(), scale.data_ptr())
    build.count(pack_int8)
    return q, scale


def unpack_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: contiguous int8 (rows, 128), scale: fp32 (rows,) -> fp32
    (rows, 128) on q's device."""
    rows = _rows(q, torch.int8, "unpack_int8: q")
    if scale.dtype != torch.float32 or not scale.is_contiguous() \
            or tuple(scale.shape) != (rows,) or scale.device != q.device:
        raise TypeError(f"unpack_int8: scale must be contiguous fp32 "
                        f"({rows},) on {q.device}")
    if q.device.type == "cpu":
        build.count(unpack_int8, "plain_calls")
        return unpack_int8_plain(q, scale)
    if q.data_ptr() % 4:
        raise ValueError("unpack_int8: q must be 4-byte aligned")
    out = torch.empty((rows, LANES), dtype=torch.float32, device=q.device)
    if rows == 0:
        return out
    with torch.cuda.device(q.device):
        build.launch("pack_int8", SIGNATURES, "repro_unpack_int8",
                     q.data_ptr(), scale.data_ptr(), rows, out.data_ptr())
    build.count(unpack_int8)
    return out


pack_int8.launches = 0          # kernel launches on the card
pack_int8.plain_calls = 0       # CPU tensors sent to the plain version
unpack_int8.launches = 0
unpack_int8.plain_calls = 0

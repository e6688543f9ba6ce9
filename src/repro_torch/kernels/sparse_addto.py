"""Sparse saturating scatter-add into the INC register file.

The int lane of the switch memory: a batch of (slot, int32 value) pairs
accumulated into a register segment in stream order, so duplicate slots
saturate exactly like the sequential oracle. On the card it is the
hand-written kernel of ``csrc/sparse_addto.cu`` (replacing the TPU kernel
``repro/kernels/sparse_addto.py:sparse_addto_pallas``); a CPU tensor takes
the plain version. The wrapper updates ``regs`` in place and returns it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {"repro_sparse_addto": (_P, _I, _P, _P, _I, _P, _P, _P)}


def check_scatter_args(regs: torch.Tensor, idx: torch.Tensor,
                       val: torch.Tensor, val_dtype: torch.dtype) -> None:
    """Device, dtype, shape and contiguity checks of a scatter launch."""
    if regs.dtype != torch.int32 or regs.dim() != 1:
        raise TypeError("regs must be a 1-D int32 tensor")
    if idx.dtype != torch.int32 or val.dtype != val_dtype:
        raise TypeError(f"idx must be int32 and values {val_dtype}")
    if idx.shape != val.shape or idx.dim() != 1:
        raise ValueError("idx and values must be 1-D of one length")
    if not (regs.device == idx.device == val.device):
        raise ValueError("regs, idx and values must share one device")
    if regs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for {regs.device.type} tensors")
    if not (regs.is_contiguous() and idx.is_contiguous()
            and val.is_contiguous()):
        raise ValueError("regs, idx and values must be contiguous")


def scatter_scratch(regs: torch.Tensor, k: int):
    """Scratch of one scatter launch: 2 * n_slots + 1 int64 words (per-slot
    mass and sum, and the unsafe count; the kernel zeroes them) and k flag
    bytes."""
    words = torch.empty(2 * regs.numel() + 1, dtype=torch.int64,
                        device=regs.device)
    unsafe = torch.empty(k, dtype=torch.uint8, device=regs.device)
    return words, unsafe


def sparse_addto_plain(regs: torch.Tensor, idx: torch.Tensor,
                       val: torch.Tensor) -> torch.Tensor:
    """The plain version: ``ref.sparse_addto`` (in place)."""
    return ref.sparse_addto(regs, idx, val)


def sparse_addto(regs: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """regs: int32 (n_slots,), idx: int32 (k,) in [0, n_slots), val: int32
    (k,). Applies regs[idx[i]] = sat_add(regs[idx[i]], val[i]) in stream
    order, IN PLACE, and returns ``regs``."""
    check_scatter_args(regs, idx, val, torch.int32)
    if regs.device.type == "cpu":
        sparse_addto.plain_calls += 1
        return sparse_addto_plain(regs, idx, val)
    k = idx.numel()
    if k == 0:
        return regs
    words, unsafe = scatter_scratch(regs, k)
    with torch.cuda.device(regs.device):
        build.launch("sparse_addto", SIGNATURES, "repro_sparse_addto",
                     regs.data_ptr(), regs.numel(), idx.data_ptr(),
                     val.data_ptr(), k, words.data_ptr(), unsafe.data_ptr())
    sparse_addto.launches += 1
    return regs


sparse_addto.launches = 0       # kernel launches on the card
sparse_addto.plain_calls = 0    # CPU tensors sent to the plain version

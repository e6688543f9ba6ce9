"""Causal flash attention: the prefill lane of the model's attention.

``flash_attention(q, k, v, causal, window)``: q (B, S, H, D), k and v
(B, S, KV, D) with H % KV == 0 -> (B, S, H, D) in q's dtype; query head h
reads kv head ``h // (H // KV)``. On the card it is the hand-written
kernel of ``csrc/flash_attn.cu`` (bf16, D of 32, 64, 128 or 256; TMA
loads, wgmma products, a producer warp and two consumer warpgroups),
replacing ``repro/kernels/flash_attn.py:flash_attention_pallas``; it
reads the (B, S, H, D) tensors through TMA tensor maps built from their
strides, so a strided view costs no copy. A CPU tensor takes the plain
version (``ref.flash_attention``, which works on the reference kernel's
(B, H, S, D) layout). A meta tensor (the dry run) passes the kernel's
checks and returns an empty output, with one record of the kernel's
operations and bytes (``roofline.flash_model.flash_work``, the count
PERF.md's bound takes) in ``backend.record_launch``.

There is no backward kernel (the reference has none either: its train
step runs the plain attention unless ``REPRO_FLASH_ATTN=1``), so the
wrapper raises when autograd would need one, on both lanes, rather than
return an output that carries no gradient.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import backend, build, ref
from repro_torch.roofline.flash_model import flash_work

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# q, k, v, out; B, S, H, KV, D; 12 strides; causal, window, sm_scale; stream
SIGNATURES = {"repro_flash_attn": (_P,) * 4 + (_I,) * 5 + (_I,) * 12
              + (_I, _I, _F, _P)}
HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    o = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2).contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_attention: q (B,S,H,D), k and v (B,S,KV,D)")
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) \
            or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not match")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: operands must share one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for {q.device.type} tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward kernel: q, k and v would get "
            "no gradient. Train with the plain attention (flash=False), or "
            "call it under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """(B,S,H,D) x (B,S,KV,D) -> (B,S,H,D) attention with an online
    softmax; ``window`` (causal only) limits each query to the last
    ``window`` keys. Returns a new contiguous tensor."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        build.count(flash_attention, "plain_calls")
        return flash_attention_plain(q, k, v, causal, window)
    for t in (q, k, v):
        # TMA: bf16, unit last stride, 16-byte base and strides
        if t.dtype != torch.bfloat16:
            raise TypeError("flash_attention: the kernel takes bf16")
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention: rows must be 16-byte aligned "
                             "with a contiguous last dim")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes D in "
                         f"{HEAD_DIMS}, got {d}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        flops, nbytes = flash_work(b, h, k.shape[2], s, d, window)
        if not causal:                  # every (q, k) pair
            flops = 4 * d * b * h * s * s
        backend.record_launch("flash_attention", nbytes, flops)
        return out
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        build.launch("flash_attn", SIGNATURES, "repro_flash_attn",
                     q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, h, k.shape[2], d,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3], int(causal),
                     int(window or 0) if causal else 0,
                     float(np.float32(d ** -0.5)))
    build.count(flash_attention)
    return out


flash_attention.launches = 0        # kernel launches on the card
flash_attention.plain_calls = 0     # CPU tensors sent to the plain version

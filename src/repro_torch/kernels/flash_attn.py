"""Causal flash attention: the prefill lane of the model's attention, and
the train lane's gradient.

``flash_attention(q, k, v, causal, window)``: q (B, S, H, D), k and v
(B, S, KV, D) with H % KV == 0 -> (B, S, H, D) in q's dtype; query head h
reads kv head ``h // (H // KV)``. On the card it is the hand-written
kernel of ``csrc/flash_attn.cu`` (bf16, D of 32, 64, 128 or 256; TMA
loads, wgmma products, a producer warp and two consumer warpgroups),
replacing ``repro/kernels/flash_attn.py:flash_attention_pallas``; it
reads the (B, S, H, D) tensors through TMA tensor maps built from their
strides, so a strided view costs no copy. A CPU tensor takes the plain
version (``ref.flash_attention``, which works on the reference kernel's
(B, H, S, D) layout), under autograd too: its gradient is the plain
version's autograd. A meta tensor (the dry run) passes the kernel's
checks and returns an empty output, with one record of the kernel's
operations and bytes (``roofline.flash_model.flash_work``, the count
PERF.md's bound takes) in ``backend.record_launch``.

Under autograd a card or meta tensor goes through ``FlashAttention``, an
``autograd.Function``: its forward launches kernel 11 with the log-sum-exp
output (fp32 (B, H, S), base 2) and saves q, k, v, o and that lse; its
backward launches the three kernels of ``csrc/flash_attn_bwd.cu``:
``flash_bwd_delta`` (sum_d dO * O), ``flash_bwd_dkdv`` (dK and dV: a KV
head's group of query heads split over the CTAs of a thread block
cluster, ``roofline.flash_model.dkdv_split``, whose partial sums meet in
shared memory in one fixed order, no atomics) and ``flash_bwd_dq``; each
streams its tiles through a two-stage cp.async ring into the swizzled
layout kernel 11's loads give, and runs every product as a wgmma (P and
dS from registers).
It is the counterpart of the reference's train step under
``REPRO_FLASH_ATTN=1``, which JAX differentiates through the chunked
oracle (``repro/kernels/flash_attn.py:flash_attention_chunked_ref``);
the TPU kernel itself has no VJP. On a CPU tensor each backward wrapper
takes its plain version (``ref.flash_bwd``; the tests hold the kernels
to it); a card tensor goes to its kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import backend, build, ref
from repro_torch.roofline.flash_model import bwd_kernel_work, \
    dkdv_split, flash_work

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# q, k, v, out, lse (or null); B, S, H, KV, D; 12 strides; causal, window,
# sm_scale; stream
SIGNATURES = {"repro_flash_attn": (_P,) * 5 + (_I,) * 5 + (_I,) * 12
              + (_I, _I, _F, _P)}
# (a) o, dO, delta; B, S, H, D; 6 strides; stream. (b) q, k, v, dO, lse,
# delta, dk, dv; B, S, H, KV, D; 18 strides; cluster, heads a CTA
# (``dkdv_split``); causal, window, sm_scale; stream. (c) as (b) with dq
# for dk and dv, 15 strides, no split
BWD_SIGNATURES = {
    "repro_flash_bwd_delta": (_P,) * 3 + (_I,) * 4 + (_I,) * 6 + (_P,),
    "repro_flash_bwd_dkdv": (_P,) * 8 + (_I,) * 5 + (_I,) * 18 + (_I, _I)
    + (_I, _I, _F, _P),
    "repro_flash_bwd_dq": (_P,) * 7 + (_I,) * 5 + (_I,) * 15
    + (_I, _I, _F, _P)}
HEAD_DIMS = (32, 64, 128, 256)


def _bhsd(*ts):
    """(B, S, heads, D) views as the plain versions' (B, heads, S, D)."""
    return tuple(t.transpose(1, 2) for t in ts)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    o = ref.flash_attention(*_bhsd(q, k, v), causal=causal, window=window)
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


def _check_kernel(*ts: torch.Tensor) -> None:
    """What the kernels read: bf16 rows of a contiguous last dim, 16-byte
    aligned, every other stride a multiple of 8 elements; D in
    HEAD_DIMS."""
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError("flash_attention: the kernel takes bf16")
        if not _readable(t):
            raise ValueError("flash_attention: rows must be 16-byte aligned "
                             "with a contiguous last dim")
    d = ts[0].shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes D in "
                         f"{HEAD_DIMS}, got {d}")


def _strides(t: torch.Tensor) -> list[int]:
    """The element strides of dims 0-2 as the kernels take them. A dim of
    size 1 is never stepped along, and PyTorch may give it any stride (a
    view that splits H * D into one head of D, a tensor autograd calls
    contiguous): it gets the stride the contiguous layout would, so the
    checks and the TMA maps see a valid one."""
    st = [0, 0, 0, t.stride(3)]
    for i in (2, 1, 0):
        st[i] = t.stride(i) if t.shape[i] > 1 \
            else t.shape[i + 1] * st[i + 1]
    return st[:3]


def _readable(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and not any(st % 8 for st in _strides(t)) \
        and t.data_ptr() % 16 == 0


def _forward(q, k, v, causal, window, with_lse: bool):
    """Kernel 11 on a card or meta tensor (checked): (out, lse or None);
    lse (B, H, S) fp32 in base 2 when ``with_lse``."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.device.type == "meta":
        flops, nbytes = flash_work(b, h, k.shape[2], s, d, window)
        if not causal:                  # every (q, k) pair
            flops = 4 * d * b * h * s * s
        backend.record_launch("flash_attention", nbytes, flops)
        return out, lse
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        build.launch("flash_attn", SIGNATURES, "repro_flash_attn",
                     q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                     b, s, h, k.shape[2], d,
                     *_strides(q), *_strides(k), *_strides(v),
                     *_strides(out), int(causal),
                     int(window or 0) if causal else 0, _scale(d))
    build.count(flash_attention)
    return out, lse


def _scale(d: int) -> float:
    return float(np.float32(d ** -0.5))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """(B,S,H,D) x (B,S,KV,D) -> (B,S,H,D) attention with an online
    softmax; ``window`` (causal only) limits each query to the last
    ``window`` keys. Returns a new contiguous tensor. Under autograd a
    card or meta tensor goes through ``FlashAttention`` (the backward
    kernels), a CPU tensor through the plain version's autograd."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        build.count(flash_attention, "plain_calls")
        return flash_attention_plain(q, k, v, causal, window)
    _check_kernel(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, False)[0]


flash_attention.launches = 0        # kernel launches on the card
flash_attention.plain_calls = 0     # CPU tensors sent to the plain version


class FlashAttention(torch.autograd.Function):
    """Kernel 11 with its backward kernels, for card and meta tensors
    (``flash_attention`` sends a CPU tensor to the plain version's
    autograd). The forward saves q, k, v, the output and the log-sum-exp;
    under the layer's checkpoint it runs twice (the forward, then the
    recompute before the backward), deterministic both times."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window=None):
        if q.device.type == "cpu":
            raise ValueError("FlashAttention takes card or meta tensors: "
                             "flash_attention sends a CPU tensor to the "
                             "plain version")
        o, lse = _forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = flash_bwd_delta(o, do)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.causal,
                                ctx.window)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def _readable_do(do: torch.Tensor) -> torch.Tensor:
    """dO as the kernels read it: autograd may hand over any layout (an
    expanded or transposed view); one the kernels cannot read through
    its strides is copied to a contiguous tensor."""
    if do.device.type != "cpu" and not _readable(do):
        return do.contiguous()
    return do


def _bwd_checks(name, q, k, v, do, lse, delta) -> None:
    if do.shape != q.shape or lse.shape != (q.shape[0], q.shape[2],
                                            q.shape[1]) \
            or delta.shape != lse.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} and delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 \
            or not lse.is_contiguous() or not delta.is_contiguous():
        raise TypeError(f"{name}: lse and delta are contiguous fp32")
    if q.device.type != "cpu":
        _check_kernel(q, k, v, do)


def _record(name, q, k, causal, window) -> None:
    b, s, h, d = q.shape
    flops, nbytes = bwd_kernel_work(name, b, h, k.shape[2], s, d,
                                    window if causal else None, causal)
    backend.record_launch(name, nbytes, flops)


def _bwd_args(q, k, v, do, lse, delta, *outs):
    """Pointers, then B, S, H, KV, D, then the strides of q, k, v, dO and
    of each output."""
    b, s, h, d = q.shape
    strides = [st for t in (q, k, v, do) + outs for st in _strides(t)]
    return ([t.data_ptr() for t in (q, k, v, do, lse, delta) + outs]
            + [b, s, h, k.shape[2], d] + strides)


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta (B, H, S) fp32 = sum_d dO * O of (B, S, H, D) tensors: kernel
    (a) of ``csrc/flash_attn_bwd.cu``."""
    if do.shape != o.shape or o.dim() != 4:
        raise ValueError(f"flash_bwd_delta: O {tuple(o.shape)} and dO "
                         f"{tuple(do.shape)}")
    b, s, h, d = o.shape
    if o.device.type == "cpu":
        build.count(flash_bwd_delta, "plain_calls")
        return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    do = _readable_do(do)
    _check_kernel(o, do)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=o.device)
    if o.device.type == "meta":
        flops, nbytes = bwd_kernel_work("flash_bwd_delta", b, h, h, s, d,
                                        None)
        backend.record_launch("flash_bwd_delta", nbytes, flops)
        return delta
    if delta.numel() == 0:
        return delta
    with torch.cuda.device(o.device):
        build.launch("flash_attn_bwd", BWD_SIGNATURES,
                     "repro_flash_bwd_delta", o.data_ptr(), do.data_ptr(),
                     delta.data_ptr(), b, s, h, d, *_strides(o),
                     *_strides(do))
    build.count(flash_bwd_delta)
    return delta


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = True,
                   window: int | None = None):
    """(dK, dV) (B, S, KV, D) in k's dtype from q, dO (B, S, H, D), k, v
    and the forward's lse and delta (B, H, S): kernel (b), the group's
    query heads split over a cluster as ``dkdv_split`` says."""
    do = _readable_do(do)
    _bwd_checks("flash_bwd_dkdv", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        build.count(flash_bwd_dkdv, "plain_calls")
        _, dk, dv = ref.flash_bwd(*_bhsd(q, k, v, do), lse, delta, causal,
                                  window)
        return (dk.transpose(1, 2).contiguous(),
                dv.transpose(1, 2).contiguous())
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.device.type == "meta":
        _record("flash_bwd_dkdv", q, k, causal, window)
        return dk, dv
    if dk.numel() == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        build.launch("flash_attn_bwd", BWD_SIGNATURES,
                     "repro_flash_bwd_dkdv",
                     *_bwd_args(q, k, v, do, lse, delta, dk, dv),
                     *dkdv_split(q.shape[2], k.shape[2]), int(causal),
                     int(window or 0) if causal else 0, _scale(q.shape[3]))
    build.count(flash_bwd_dkdv)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 window: int | None = None) -> torch.Tensor:
    """dQ (B, S, H, D) in q's dtype: kernel (c)."""
    do = _readable_do(do)
    _bwd_checks("flash_bwd_dq", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        build.count(flash_bwd_dq, "plain_calls")
        dq, _, _ = ref.flash_bwd(*_bhsd(q, k, v, do), lse, delta, causal,
                                 window)
        return dq.transpose(1, 2).contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.device.type == "meta":
        _record("flash_bwd_dq", q, k, causal, window)
        return dq
    if dq.numel() == 0:
        return dq
    with torch.cuda.device(q.device):
        build.launch("flash_attn_bwd", BWD_SIGNATURES, "repro_flash_bwd_dq",
                     *_bwd_args(q, k, v, do, lse, delta, dq),
                     int(causal), int(window or 0) if causal else 0,
                     _scale(q.shape[3]))
    build.count(flash_bwd_dq)
    return dq


for _fn in (flash_bwd_delta, flash_bwd_dkdv, flash_bwd_dq):
    _fn.launches = 0                # kernel launches on the card
    _fn.plain_calls = 0             # CPU tensors sent to the plain version

"""Plain PyTorch versions of the port's kernels: the INC kernel family
and flash attention.

These are the semantic ground truth of the port: each hand-written CUDA
kernel in this package is held against the function here on the card,
and the CPU tests hold these against the JAX package's kernels. A kernel
wrapper runs them itself only for tensors that lie on the CPU.

Every function works on tensors of any device; integer arithmetic runs in
int64, so no step depends on how int32 overflow wraps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.constants import INT32_MAX, INT32_MIN, SAT_MAX

# float32(SAT_MAX) rounds up to 2**31: the quantize thresholds compare in
# fp32, exactly like the reference kernel's ``y > float(SAT_MAX)``
_F32_TWO31 = 2.0 ** 31
# the largest float32 below 2**31, used to clamp before the int cast
_F32_BELOW_TWO31 = 2147483520.0


# ---------------------------------------------------------------------------
# fixed-point quantization (paper §5.2.1, NetFilter "Precision")
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """fp32 -> int32 fixed point: round-half-even(x*scale) in fp32,
    saturating to the sentinels.

    The thresholds compare in fp32, where SAT_MAX rounds to 2**31: so
    y > 2**31 gives the +sentinel, y < -2**31 the -sentinel, y == 2**31
    saturates to 2147483647 through the int cast (also the +sentinel),
    and y == -2**31 stores -2147483648, which is *not* a sentinel. NaN
    quantizes to 0, as the saturating conversion does on the card.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    y = torch.round(x * s)                       # round half to even
    y = torch.nan_to_num(y, nan=0.0, posinf=_F32_TWO31 * 2,
                         neginf=-_F32_TWO31 * 2)
    q = y.clamp(-_F32_TWO31, _F32_BELOW_TWO31).to(torch.int32)
    q = torch.where(y >= _F32_TWO31, torch.full_like(q, INT32_MAX), q)
    q = torch.where(y < -_F32_TWO31, torch.full_like(q, INT32_MIN), q)
    return q


def dequantize(q: torch.Tensor, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 fixed point -> (fp32 value, overflow mask).

    Multiplies by the fp32 reciprocal ``1 / float32(scale)`` (not a
    divide), like the reference kernel, so replies agree bit for bit.
    """
    inv = (torch.tensor(1.0, dtype=torch.float32)
           / torch.tensor(scale, dtype=torch.float32)).to(q.device)
    return q.to(torch.float32) * inv, is_sentinel(q)


def is_sentinel(q: torch.Tensor) -> torch.Tensor:
    return (q == INT32_MAX) | (q == INT32_MIN)


# ---------------------------------------------------------------------------
# saturating Map.addTo (the per-hop switch accumulate)
# ---------------------------------------------------------------------------

def sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 saturating add with sticky sentinels.

    - a true sum above 2**31-1 gives the +sentinel, below -2**31 the
      -sentinel; a sum of exactly -2**31 stays as it is (the reference's
      wrapped-add reconstruction does the same);
    - an input sentinel is sticky, and ``a``'s sentinel wins a conflict.
    """
    a64 = torch.as_tensor(a).to(torch.int64)
    b64 = torch.as_tensor(b).to(torch.int64)
    s = a64 + b64
    s = torch.where(s > 2 ** 31 - 1, torch.full_like(s, INT32_MAX), s)
    s = torch.where(s < -2 ** 31, torch.full_like(s, INT32_MIN), s)
    for v, sentinel in ((b64, INT32_MAX), (b64, INT32_MIN),
                        (a64, INT32_MAX), (a64, INT32_MIN)):
        s = torch.where(v == sentinel, torch.full_like(s, sentinel), s)
    return s.to(torch.int32)


def _sat_add_scalar(a: int, b: int) -> int:
    """Exact scalar sat_add: sticky sentinels (a's wins), then the
    overflow rule on the true integer sum."""
    for x in (a, b):
        if x == INT32_MAX:
            return INT32_MAX
        if x == INT32_MIN:
            return INT32_MIN
    s = a + b
    if s > 2 ** 31 - 1:
        return INT32_MAX
    if s < -2 ** 31:
        return INT32_MIN
    return s


# ---------------------------------------------------------------------------
# sparse Map.addTo into a register file (the INC map, paper §5.2.2)
# ---------------------------------------------------------------------------

def sparse_addto(regs: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """regs[idx[i]] = sat_add(regs[idx[i]], val[i]) applied in stream
    order i = 0..k-1; updates ``regs`` IN PLACE and returns it.

    Order only matters on a slot that can saturate. A slot whose
    |reg| + sum|val| stays within SAT_MAX can reach no sentinel at any
    prefix of the stream, in any order, so its updates collapse into one
    exact sum; the updates of every other slot run one by one, in stream
    order. Every update of a slot falls on the same side of that split.
    """
    if idx.numel() == 0:
        return regs
    idx = idx.to(torch.int64)
    val = val.to(torch.int64)
    cur = regs.to(torch.int64)
    mass = torch.zeros_like(cur).index_add_(0, idx, val.abs())
    safe_slot = cur.abs() + mass <= SAT_MAX
    safe = safe_slot[idx]
    sums = torch.zeros_like(cur).index_add_(0, idx[safe], val[safe])
    new = torch.where(safe_slot, cur + sums, cur)
    unsafe = torch.nonzero(~safe).flatten()
    if unsafe.numel():
        u_idx = idx[unsafe].tolist()
        u_val = val[unsafe].tolist()
        touched = sorted(set(u_idx))
        acc = dict(zip(touched, cur[torch.tensor(touched, device=cur.device)]
                       .tolist()))
        for j, v in zip(u_idx, u_val):
            acc[j] = _sat_add_scalar(acc[j], v)
        new[torch.tensor(list(acc), device=cur.device)] = torch.tensor(
            list(acc.values()), dtype=torch.int64, device=cur.device)
    regs.copy_(new.to(torch.int32))
    return regs


# ---------------------------------------------------------------------------
# Stream.modify (paper Table 8) — elementwise stream arithmetic
# ---------------------------------------------------------------------------

STREAM_OPS = ("nop", "max", "min", "add", "assign",
              "shiftl", "shiftr", "band", "bor", "bnot", "bxor")


# ---------------------------------------------------------------------------
# block-scaled int8 pack (the int8 wire format of ops.pack_int8)
# ---------------------------------------------------------------------------

def pack_int8_block(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (rows, lanes) -> (int8 q, fp32 per-row scale).

    scale = max|row| / 127 (a zero row gets scale 1, so it unpacks to
    exact zeros); q = round-half-even(x / scale) clipped to [-127, 127].
    Both the scale and q come from IEEE divides by a tensor: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal."""
    x = torch.as_tensor(x, dtype=torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def unpack_int8_block(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def stream_modify(v: torch.Tensor, op: str, para: int = 0) -> torch.Tensor:
    """Apply one Table-8 arithmetic op to an int32 stream."""
    v = torch.as_tensor(v).to(torch.int32)
    p = torch.tensor(para, dtype=torch.int32, device=v.device)
    if op == "nop":
        return v
    if op == "max":
        return torch.maximum(v, p)
    if op == "min":
        return torch.minimum(v, p)
    if op == "add":
        return sat_add(v, p.expand_as(v))
    if op == "assign":
        return p.expand_as(v).clone()
    if op == "shiftl":
        return v << p
    if op == "shiftr":
        return v >> p
    if op == "band":
        return v & p
    if op == "bor":
        return v | p
    if op == "bnot":
        return ~v
    if op == "bxor":
        return v ^ p
    raise ValueError(f"unknown Stream.modify op: {op!r}")


# ---------------------------------------------------------------------------
# flash attention oracle (kernels/flash_attn.py)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B,H,S,D); k/v: (B,KV,S,D) -> (B,H,S,D). fp32 scores times
    ``D**-0.5``, the causal/window mask to -1e30, an fp32 softmax, the
    output cast to q's dtype: ``flash_attention_lse``'s output."""
    return flash_attention_lse(q, k, v, causal, window)[0]


LOG2E = 1.4426950408889634


def _flash_mask(s: int, causal: bool, window, device):
    """(S, S) keys each query keeps, or None (non-causal: every key)."""
    if not causal:
        return None
    pos = torch.arange(s, device=device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask = mask & (pos[:, None] - pos[None, :] < window)
    return mask


def _flash_scores(q, k, causal, window):
    """fp32 scores (B, KV, G, S, S) times ``D**-0.5`` (the kernel's fp32
    scale), the mask, and the (B, KV, G, S, D) fp32 queries."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, s, d).float()
    scale = float(np.float32(d ** -0.5))
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    return scores, _flash_mask(s, causal, window, q.device), qg, scale


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` and each row's log-sum-exp (B, H, S) fp32 in
    the kernel's base-2 domain: log2 sum_j exp2(s_j log2(e)) over the kept
    keys, so ``exp2(s log2(e) - lse)`` is the row's softmax."""
    b, h, s, d = q.shape
    scores, mask, _, _ = _flash_scores(q, k, causal, window)
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.tensor(-1e30, dtype=torch.float32,
                                          device=q.device))
    lse = torch.logsumexp(scores, dim=-1) * LOG2E
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(scores, dim=-1),
                     v.float())
    return o.reshape(b, h, s, d).to(q.dtype), lse.reshape(b, h, s)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              causal: bool = True, window: int | None = None,
              round_to: torch.dtype | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention`` from the forward's ``lse`` and
    ``delta`` = sum_d dO * O (both (B, H, S) fp32): q and dO (B,H,S,D),
    k and v (B,KV,S,D) -> (dq, dk, dv) in their inputs' dtypes. In fp32:
    P = exp2(s log2(e) - lse) on the kept keys and 0 elsewhere, dP = dO
    V^T, dS = P (dP - delta), dV = sum over the group of P^T dO, dK = scale
    sum over the group of dS^T Q, dQ = scale dS K. ``round_to`` rounds P
    and dS to that dtype before the products that take them, as the
    kernels round them to bf16 (csrc/flash_attn_bwd.cu)."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    scores, mask, qg, scale = _flash_scores(q, k, causal, window)
    p = torch.exp2(scores * LOG2E - lse.reshape(b, kv, h // kv, s, 1))
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=q.device))
    dog = do.reshape(b, kv, h // kv, s, d).float()
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    ds = p * (dp - delta.reshape(b, kv, h // kv, s, 1))
    if round_to is not None:
        p, ds = p.to(round_to).float(), ds.to(round_to).float()
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        round_to: torch.dtype | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_bwd`` with delta = sum_d dO * O in fp32: the plain version
    of the three backward kernels together, (B,H,S,D) layout."""
    delta = (do.float() * o.float()).sum(-1)
    return flash_bwd(q, k, v, do, lse, delta, causal, window, round_to)

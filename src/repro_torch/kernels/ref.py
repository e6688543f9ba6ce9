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
    output cast to q's dtype."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, s, d).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * (d ** -0.5)
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        if window is not None:
            mask = mask & (pos[:, None] - pos[None, :] < window)
        scores = torch.where(mask, scores,
                             torch.tensor(-1e30, dtype=torch.float32,
                                          device=q.device))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(b, h, s, d).to(q.dtype)

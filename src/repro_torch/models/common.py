"""Shared model components: norms, RoPE, sinusoidal positions,
initializers, dtype policy.

The port of ``repro/models/common.py``, with its conventions:
  - parameters are bf16 (fp32 for norm scales);
  - activations are bf16; softmax and norm statistics are fp32;
  - every stacked-over-layers leaf has the layer dim first.

Random init takes an explicit ``torch.Generator``. It cannot reproduce
``jax.random``'s values, so the tests carry the reference's weights across
(``models/api.py:params_from_jax``) instead of drawing them twice.
"""
from __future__ import annotations

import math

import torch

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


# a draw larger than this many fp32 bytes goes a slice of the leading
# (layer) dim at a time into the finished leaf: moonshot-v1-16b-a3b's
# expert leaves (48, 64, 2048, 1408) would take 35.4 GB in one fp32 draw
# and as much again scaled, more than the card holds beside the leaves
# already drawn. Every leaf of qwen2.5-3b, gemma3-27b and
# recurrentgemma-9b (the largest, gemma3's embedding, 5.6 GB) stays one
# draw, so their values do not change.
DRAW_LIMIT_BYTES = 8 << 30


def draw(gen: torch.Generator | None, shape, device, fn) -> torch.Tensor:
    """fp32 ``fn(shape)`` (``torch.randn``, ``torch.rand``) drawn from
    ``gen`` on ``device``; shapes only on the meta device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return fn(shape, generator=gen, dtype=torch.float32, device=device)


def dense_init(gen: torch.Generator | None, shape, fan_in: int | None = None,
               dtype=PARAM_DTYPE, device="cpu") -> torch.Tensor:
    """N(0, fan_in**-1) drawn in fp32 from ``gen`` on ``device``, then cast;
    past ``DRAW_LIMIT_BYTES`` of fp32 one slice of the leading dim at a
    time, into the leaf. On the meta device (shapes only) ``gen`` is not
    used."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan = fan_in if fan_in is not None else shape[0]
    if 4 * math.prod(shape) > DRAW_LIMIT_BYTES and len(shape) > 1:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = dense_init(gen, shape[1:], fan, dtype, device)
        return out
    x = draw(gen, shape, device, torch.randn)
    return (x * fan ** -0.5).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with fp32 statistics; the scale is stored as (scale - 1),
    so a zero scale is the identity."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rms_norm_init(d: int, *, lead: tuple = (), device="cpu") -> torch.Tensor:
    """fp32 zeros (the identity), with ``lead`` (the layer dim) in
    front."""
    return torch.zeros(lead + (d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq). Computed in fp32 on the two halves of head_dim (not
    interleaved)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (..., seq, d/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., seq, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_freqs(d: int, device="cpu") -> torch.Tensor:
    """(d/2,) fp32 1 / 10000**(2i/d). The power is taken in float64 and
    rounded once: XLA's fp32 power is correctly rounded at these
    exponents and PyTorch's CPU one is not at 4 of whisper's 512, which
    moved a table entry by 3e-5 at position 1 499."""
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (10_000.0 ** exps.double()).float()


def sinusoidal_positions(n: int, d: int, device="cpu") -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings, (n, d) fp32: the sines of
    the angles pos / 10000**(2i/d), then their cosines."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    ang = pos * sinusoid_freqs(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

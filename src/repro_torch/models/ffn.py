"""Feed-forward layers: the SwiGLU of the dense blocks.

The port of the dense half of ``repro/models/ffn.py``; the GELU MLP and
the MoE layer come with the block types that use them (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_swiglu(gen, d: int, ff: int, *, lead: tuple = (),
                device="cpu") -> dict:
    return {"w1": dense_init(gen, lead + (d, ff), fan_in=d, device=device),
            "w3": dense_init(gen, lead + (d, ff), fan_in=d, device=device),
            "w2": dense_init(gen, lead + (ff, d), fan_in=ff, device=device)}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]

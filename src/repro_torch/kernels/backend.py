"""Device selection for the port's entry points.

``SwitchMemory``, ``Controller``, ``NetRPC`` and ``IncRuntime`` take
``device=``. ``None`` means the card: the port runs its register file on
CUDA unless the caller asks for the CPU, and without a card it raises
instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for (or defaulted
    to) and no card is present. ``"cpu"`` is the tests' lane."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

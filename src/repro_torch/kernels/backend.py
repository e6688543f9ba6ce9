"""Device selection for the port's entry points.

``SwitchMemory``, ``Controller``, ``NetRPC`` and ``IncRuntime`` take
``device=``. ``None`` means the card: the port runs its register file on
CUDA unless the caller asks for the CPU, and without a card it raises
instead of falling back. ``"meta"`` is the dry run's lane
(``launch/dryrun.py``): tensors with shapes and no data, whose kernels
launch nothing and report their work to ``record_launch``.
"""
from __future__ import annotations

import torch


# the open roofline counters (``roofline.analysis.Counter``), to which a
# kernel called on meta tensors reports its work
RECORDERS: list = []


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for (or defaulted
    to) and no card is present. ``"cpu"`` is the tests' lane, ``"meta"``
    the dry run's, taken only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def record_launch(name: str, nbytes: float, flops: float = 0.0) -> None:
    """A kernel called on meta tensors: nothing launches, and every open
    counter records one launch of ``name`` with its analytic HBM bytes
    and FLOPs (what the hand kernel moves, not what its plain version
    would)."""
    for r in RECORDERS:
        r.kernel(name, nbytes, flops)

"""The switch's saturating Map.addTo: the per-hop accumulate.

Each hop of the SyncAgtr ring (core/ring.py) and each accumulate of the
clear policies (core/clear_policy.py) adds an int32 stream into another,
saturating on overflow to the MAX_INT/MIN_INT sentinels and keeping
sentinels sticky (``a``'s wins), so a receiver finds every lane that
overflowed on any hop.

  - ``sat_add(a, b)``: elementwise, any shape;
  - ``sat_add_batch(acc, qs)``: the B rows of ``qs`` folded into ``acc``
    in row order in one launch (the order matters once a lane saturates).

On the card these are the hand-written kernels of ``csrc/inc_agg.cu``,
replacing ``repro/kernels/inc_agg.py:sat_add_pallas`` and the scan over
it in ``repro/kernels/ops.py:_sat_add_batch_tpu``. A CPU tensor takes the
plain version, a meta tensor (the dry run) an empty output and one
record of the kernel's bytes (``backend.record_launch``). Both return a
new tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend, build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {"repro_sat_add": (_P, _P, _P, _I),
              "repro_sat_add_batch": (_P, _P, _I, _I, _P)}


def _check(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: operands must be contiguous int32")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: operands must share one device")
    if ts[0].device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for {ts[0].device.type} tensors")


def sat_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ref.sat_add(a, b)


def sat_add_batch_plain(acc: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """The sequential fold ``for q in qs: acc = sat_add(acc, q)``."""
    for q in qs:
        acc = ref.sat_add(acc, q)
    return acc


def sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 saturating add with sticky sentinels, elementwise; a and b
    of one shape. Returns a new tensor."""
    _check("sat_add", a, b)
    if a.shape != b.shape:
        raise ValueError(f"sat_add: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if a.device.type == "cpu":
        build.count(sat_add, "plain_calls")
        return sat_add_plain(a, b)
    out = torch.empty_like(a)
    if a.device.type == "meta":
        # a and b read once, the sum written once
        backend.record_launch("sat_add", 12 * a.numel())
        return out
    if a.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        build.launch("inc_agg", SIGNATURES, "repro_sat_add", a.data_ptr(),
                     b.data_ptr(), out.data_ptr(), a.numel())
    build.count(sat_add)
    return out


def sat_add_batch(acc: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """acc: int32 (...); qs: int32 (B, ...). Folds the B rows into acc in
    row order, result-identical to the sequential ``sat_add`` fold.
    Returns a new tensor."""
    _check("sat_add_batch", acc, qs)
    if qs.dim() != acc.dim() + 1 or qs.shape[1:] != acc.shape:
        raise ValueError(f"sat_add_batch: qs {tuple(qs.shape)} must be "
                         f"(B,) + acc's shape {tuple(acc.shape)}")
    if acc.device.type == "cpu":
        build.count(sat_add_batch, "plain_calls")
        return sat_add_batch_plain(acc, qs)
    out = torch.empty_like(acc)
    if acc.device.type == "meta":
        # acc and the B rows read once, the fold written once
        backend.record_launch("sat_add_batch",
                              (4 * qs.shape[0] + 8) * acc.numel())
        return out
    if acc.numel() == 0:
        return out
    with torch.cuda.device(acc.device):
        build.launch("inc_agg", SIGNATURES, "repro_sat_add_batch",
                     acc.data_ptr(), qs.data_ptr(), qs.shape[0], acc.numel(),
                     out.data_ptr())
    build.count(sat_add_batch)
    return out


for _fn in (sat_add, sat_add_batch):
    _fn.launches = 0        # kernel launches on the card
    _fn.plain_calls = 0     # CPU tensors sent to the plain version

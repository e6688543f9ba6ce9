"""The fused device-resident GPV data plane.

A device-backed switch segment (core/inc_map.py:DeviceSegment) keeps its
registers as an int32 tensor and runs its fp32 verbs as one kernel each:

  - ``fused_addto``: quantize an fp32 update stream and saturating-add it
    into the contiguous slot range [start, start+n) (the dense GPV
    transmit); ``fused_addto_runs`` does the same for several runs, each
    into its own segment, in one launch per ``MAX_RUNS`` runs (a transmit
    that spans several segments);
  - ``fused_scatter``: the same quantize, then an ordered saturating
    scatter-add, so duplicate slots saturate exactly like the sequential
    oracle (runs that are not contiguous, e.g. after LRU re-grants);
  - ``fused_read``: gather [start, start+n) and dequantize by the fp32
    reciprocal, with the overflow-sentinel mask (the device Get reply);
    ``fused_read_runs`` does the same for several runs, each from its own
    segment, into one output, in one launch per ``MAX_RUNS`` runs (a reply
    that spans several segments), with the raw registers if asked;
  - ``fused_fold``: quantize R fp32 rounds and fold them in round order
    with the saturating add (the device lane of ``local_accum``).

On the card these are the hand-written kernels of ``csrc/fused_gpv.cu``,
replacing ``repro/kernels/fused_gpv.py``'s ``fused_addto_pallas``,
``fused_scatter_pallas``, ``fused_read_pallas`` and ``fused_fold_pallas``.
A CPU tensor takes the plain version beside each wrapper. ``fused_addto``
and ``fused_scatter`` update ``regs`` IN PLACE and return it.
"""
from __future__ import annotations

import collections
import ctypes
import time

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.sparse_addto import (KS_KEPT, LANES,
                                              check_scatter_args,
                                              launch_scatter)
from repro_torch.obs import hooks as _obs

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "repro_fused_addto": (_P, _I, _P, _I, _F, _P),
    "repro_fused_addto_runs": (_P, _I, _P, _F),
    "repro_fused_read": (_P, _I, _I, _F, _P, _P, _P),
    "repro_fused_read_runs": (_P, _I, _F, _P, _P, _P),
    "repro_fused_scatter": (_P, _I, _P, _P, _I, _F, _P, _P, _P),
    "repro_fused_fold": (_P, _I, _I, _F, _P),
}


# runs in one launch of fused_addto_runs and fused_read_runs: INC_MAX_RUNS
# of csrc/fused_gpv.cu, whose entry points refuse a longer table
MAX_RUNS = 32


class _Run(ctypes.Structure):
    """One run of ``repro_fused_addto_runs`` or ``repro_fused_read_runs``
    (``IncRun`` of the source)."""
    _fields_ = [("regs", ctypes.c_void_p), ("start", ctypes.c_int64),
                ("n", ctypes.c_int64), ("off", ctypes.c_int64)]


def _run_table(chunk):
    """``(regs, start, off, n)`` runs as the C array of their table."""
    return (_Run * len(chunk))(*(_Run(regs.data_ptr(), start, n, off)
                                 for regs, start, off, n in chunk))


def _check_runs(runs, m: int, device, what: str) -> list:
    """The non-empty runs of a runs call, as ints, after checking each
    run's slots, its span [off, off+n) of an ``m``-long stream, and that
    its regs lie on ``device``."""
    runs = [(regs, int(start), int(off), int(n))
            for regs, start, off, n in runs if n]
    for regs, start, off, n in runs:
        if off < 0 or n < 0 or off + n > m:
            raise ValueError(f"{what} [{off}, {off + n}) outside the "
                             f"{m}-value stream")
        _check_range(regs, start, n)
        if regs.device != device:
            raise ValueError(f"every run's regs must lie on {device}")
    return runs


def _f32(scale) -> float:
    """The fp32 value of ``scale``, as the kernels see it."""
    return float(np.float32(scale))


def _launch(fn: str, *args) -> None:
    build.launch("fused_gpv", SIGNATURES, fn, *args)


def _check_range(regs: torch.Tensor, start: int, n: int) -> None:
    if regs.dtype != torch.int32 or regs.dim() != 1:
        raise TypeError("regs must be a 1-D int32 tensor")
    if not regs.is_contiguous():
        raise ValueError("regs must be contiguous")
    if regs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for {regs.device.type} tensors")
    if start < 0 or start + n > regs.numel():
        raise ValueError(f"slot range [{start}, {start + n}) outside the "
                         f"{regs.numel()}-slot segment")


# -- plain versions -----------------------------------------------------------

def fused_addto_plain(regs, start: int, fvals, scale):
    n = fvals.numel()
    q = ref.quantize(fvals, scale)
    regs[start:start + n] = ref.sat_add(regs[start:start + n], q)
    return regs


def fused_addto_runs_plain(runs, fvals, scale):
    for regs, start, off, n in runs:
        fused_addto_plain(regs, start, fvals[off:off + n], scale)


def fused_scatter_plain(regs, idx, fvals, scale):
    return ref.sparse_addto(regs, idx, ref.quantize(fvals, scale))


def fused_read_plain(regs, start: int, n: int, scale):
    return ref.dequantize(regs[start:start + n], scale)


def fused_read_runs_plain(runs, m: int, scale, want_raw: bool = False):
    dev = runs[0][0].device
    out = torch.empty(m, dtype=torch.float32, device=dev)
    mask = torch.empty(m, dtype=torch.bool, device=dev)
    raw = torch.empty(m, dtype=torch.int32, device=dev) if want_raw else None
    for regs, start, off, n in runs:
        out[off:off + n], mask[off:off + n] = fused_read_plain(
            regs, start, n, scale)
        if want_raw:
            raw[off:off + n] = regs[start:start + n]
    return out, mask, raw


def fused_fold_plain(fstack, scale):
    acc = ref.quantize(fstack[0], scale)
    for r in range(1, fstack.shape[0]):
        acc = ref.sat_add(acc, ref.quantize(fstack[r], scale))
    return acc


# -- kernel wrappers ----------------------------------------------------------

def fused_addto(regs: torch.Tensor, start: int, fvals: torch.Tensor,
                scale) -> torch.Tensor:
    """regs: int32 (n_slots,); fvals: fp32 (n,). Saturating-adds
    ``quantize(fvals, scale)`` over slots [start, start+n) IN PLACE and
    returns ``regs``."""
    n = fvals.numel()
    _check_range(regs, start, n)
    if fvals.dtype != torch.float32 or not fvals.is_contiguous() \
            or fvals.device != regs.device:
        raise TypeError("fvals must be contiguous fp32 on regs' device")
    if regs.device.type == "cpu":
        build.count(fused_addto, "plain_calls")
        return fused_addto_plain(regs, start, fvals, scale)
    if n == 0:
        return regs
    t0 = time.perf_counter() if _obs.METRICS else 0.0
    with torch.cuda.device(regs.device):
        _launch("repro_fused_addto", regs.data_ptr(), start,
                fvals.data_ptr(), n, _f32(scale))
    build.count(fused_addto)
    if _obs.METRICS:
        _obs.kernel_launch("fused_addto", n, t0)
    return regs


def fused_addto_runs(runs, fvals: torch.Tensor, scale) -> None:
    """runs: ``(regs, start, off, n)`` tuples; fvals: fp32 (m,). For each
    run, saturating-adds ``quantize(fvals[off:off+n], scale)`` over slots
    [start, start+n) of its ``regs`` IN PLACE. The runs' slot ranges must
    not overlap. One launch (one count in ``fused_addto.launches``) per
    ``MAX_RUNS`` non-empty runs."""
    if fvals.dtype != torch.float32 or fvals.dim() != 1 \
            or not fvals.is_contiguous():
        raise TypeError("fvals must be a contiguous 1-D fp32 tensor")
    runs = _check_runs(runs, fvals.numel(), fvals.device, "values")
    spans = sorted((regs.data_ptr() + 4 * start,
                    regs.data_ptr() + 4 * (start + n))
                   for regs, start, _, n in runs)
    if any(b[0] < a[1] for a, b in zip(spans, spans[1:])):
        raise ValueError("runs overlap: each must write its own slots")
    for c in range(0, len(runs), MAX_RUNS):
        chunk = runs[c:c + MAX_RUNS]
        if fvals.device.type == "cpu":
            build.count(fused_addto, "plain_calls")
            fused_addto_runs_plain(chunk, fvals, scale)
            continue
        t0 = time.perf_counter() if _obs.METRICS else 0.0
        table = _run_table(chunk)
        with torch.cuda.device(fvals.device):
            _launch("repro_fused_addto_runs", ctypes.addressof(table),
                    len(chunk), fvals.data_ptr(), _f32(scale))
        build.count(fused_addto)
        if _obs.METRICS:
            _obs.kernel_launch("fused_addto", sum(r[3] for r in chunk), t0)


def fused_scatter(regs: torch.Tensor, idx: torch.Tensor,
                  fvals: torch.Tensor, scale) -> torch.Tensor:
    """regs: int32 (n_slots,); idx: int32 (k,) in [0, n_slots); fvals:
    fp32 (k,). Quantizes the stream, then applies the saturating
    scatter-add in stream order, IN PLACE; returns ``regs``."""
    check_scatter_args(regs, idx, fvals, torch.float32)
    if regs.device.type == "cpu":
        build.count(fused_scatter, "plain_calls")
        return fused_scatter_plain(regs, idx, fvals, scale)
    k = idx.numel()
    if k == 0:
        return regs
    t0 = time.perf_counter() if _obs.METRICS else 0.0
    launch_scatter(fused_scatter, "fused_gpv", SIGNATURES,
                   "repro_fused_scatter", regs, k, regs.data_ptr(),
                   regs.numel(), idx.data_ptr(), fvals.data_ptr(), k,
                   _f32(scale))
    if _obs.METRICS:
        _obs.kernel_launch("fused_scatter", k, t0)
    return regs


def fused_read(regs: torch.Tensor, start: int, n: int, scale
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """regs: int32 (n_slots,) -> (fp32 values (n,), bool sentinel mask
    (n,)) of slots [start, start+n), on regs' device. Values are
    ``q.f32 * (1 / float32(scale))``, bit for bit the host fallback's."""
    _check_range(regs, start, n)
    if regs.device.type == "cpu":
        build.count(fused_read, "plain_calls")
        return fused_read_plain(regs, start, n, scale)
    out = torch.empty(n, dtype=torch.float32, device=regs.device)
    mask = torch.empty(n, dtype=torch.bool, device=regs.device)
    if n == 0:
        return out, mask
    inv = float(np.float32(1.0) / np.float32(scale))
    t0 = time.perf_counter() if _obs.METRICS else 0.0
    with torch.cuda.device(regs.device):
        _launch("repro_fused_read", regs.data_ptr(), start, n, inv,
                out.data_ptr(), mask.data_ptr())
    build.count(fused_read)
    if _obs.METRICS:
        _obs.kernel_launch("fused_read", n, t0)
    return out, mask


def fused_read_runs(runs, m: int, scale, *, want_raw: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor,
                               torch.Tensor | None]:
    """runs: ``(regs, start, off, n)`` tuples, every regs int32 on one
    device; their output ranges [off, off+n) must cover [0, m) without
    overlap. Returns (fp32 values (m,), bool sentinel mask (m,), int32 raw
    registers (m,) when ``want_raw`` else None), on the regs' device: run
    r's part is ``fused_read(regs, start, n, scale)`` (and ``regs[start:
    start+n]``) at [off, off+n). One launch (one count in
    ``fused_read.launches``) per ``MAX_RUNS`` non-empty runs."""
    if not runs:
        raise ValueError("fused_read_runs needs at least one run")
    given, dev = runs, runs[0][0].device
    runs = _check_runs(runs, m, dev, "outputs")
    end = 0
    # each run starts where the one before ends, and m where the last ends
    for _, _, off, n in sorted(runs, key=lambda r: r[2]) + [(0, 0, m, 0)]:
        if off != end:
            raise ValueError(f"the runs' outputs do not tile [0, {m})")
        end += n
    if dev.type == "cpu":
        fused_read.plain_calls += -(-len(runs) // MAX_RUNS)
        return fused_read_runs_plain(given, m, scale, want_raw)
    out = torch.empty(m, dtype=torch.float32, device=dev)
    mask = torch.empty(m, dtype=torch.bool, device=dev)
    raw = torch.empty(m, dtype=torch.int32, device=dev) if want_raw else None
    inv = float(np.float32(1.0) / np.float32(scale))
    for c in range(0, len(runs), MAX_RUNS):
        chunk = runs[c:c + MAX_RUNS]
        t0 = time.perf_counter() if _obs.METRICS else 0.0
        table = _run_table(chunk)
        with torch.cuda.device(dev):
            _launch("repro_fused_read_runs", ctypes.addressof(table),
                    len(chunk), inv, out.data_ptr(), mask.data_ptr(),
                    raw.data_ptr() if want_raw else None)
        build.count(fused_read)
        if _obs.METRICS:
            _obs.kernel_launch("fused_read", sum(r[3] for r in chunk), t0)
    return out, mask, raw


def fused_fold(fstack: torch.Tensor, scale) -> torch.Tensor:
    """fstack: fp32 (R, n), R >= 1 -> int32 (n,): every round quantized,
    then folded with the switch's saturating add in round order, so a
    fold that saturates ends on the sticky sentinel."""
    if fstack.dtype != torch.float32 or fstack.dim() != 2 \
            or not fstack.is_contiguous() or fstack.shape[0] < 1:
        raise TypeError("fstack must be a contiguous fp32 (rounds, n) "
                        "tensor with at least one round")
    if fstack.device.type == "cpu":
        build.count(fused_fold, "plain_calls")
        return fused_fold_plain(fstack, scale)
    if fstack.device.type != "cuda":
        raise ValueError(f"no kernel for {fstack.device.type} tensors")
    r, n = fstack.shape
    out = torch.empty(n, dtype=torch.int32, device=fstack.device)
    if n == 0:
        return out
    t0 = time.perf_counter() if _obs.METRICS else 0.0
    with torch.cuda.device(fstack.device):
        _launch("repro_fused_fold", fstack.data_ptr(), r, n, _f32(scale),
                out.data_ptr())
    build.count(fused_fold)
    if _obs.METRICS:
        _obs.kernel_launch("fused_fold", r * n, t0)
    return out


for _fn in (fused_addto, fused_scatter, fused_read, fused_fold):
    _fn.launches = 0        # kernel launches on the card
    _fn.plain_calls = 0     # CPU tensors sent to the plain version
fused_scatter.lanes = dict.fromkeys(LANES, 0)   # launches per scatter lane
fused_scatter.ks = collections.deque(maxlen=KS_KEPT)  # k of each launch

"""Dispatching wrappers around the port's kernels.

Two families go through here:

- the INC kernels. The switch memory (core/inc_map.py) calls these. A
  register segment is either a numpy array (a host segment of a CPU
  switch, updated by the exact numpy host kernels below) or an int32
  tensor (every segment of a CUDA switch, and device-resident segments
  everywhere), updated by the kernel wrappers of ``fused_gpv`` and
  ``sparse_addto``. The SyncAgtr path (core/quantize.py, core/ring.py) and
  the clear policies call the stream verbs ``quantize``, ``dequantize``,
  ``sat_add`` and ``sat_add_batch`` the same way. Tensor wrappers of the
  register file update the segment in place and return it, so callers
  keep assigning the result back (``seg.regs = ops.sparse_addto(...)``).
- attention: the model's prefill (models/attention.py) calls
  ``flash_attention`` on (B, S, H, D) activations;
- the int8 wire format: ``pack_int8`` / ``unpack_int8`` turn a flat fp32
  stream into int8 rows of 128 lanes with one fp32 scale each, and back.

Every wrapper runs the hand-written kernel for a CUDA tensor and the
plain version for a CPU tensor, and counts both (``launch_counts``,
``plain_counts``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import dequantize as _dequantize
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import fused_gpv
from repro_torch.kernels import inc_agg
from repro_torch.kernels import pack_int8 as _pack
from repro_torch.kernels import quantize as _quantize
from repro_torch.kernels import sparse_addto as _sparse
from repro_torch.kernels.constants import DEFAULT_BLOCK_ROWS, LANES, SAT_MAX
from repro_torch.kernels.ref import _sat_add_scalar

# every kernel wrapper of the port, for launch accounting: the INC family
# (register file, fold, SyncAgtr stream verbs), the attention kernel and
# its three backward kernels, and the int8 pack
KERNELS = {"fused_addto": fused_gpv.fused_addto,
           "fused_scatter": fused_gpv.fused_scatter,
           "fused_read": fused_gpv.fused_read,
           "sparse_addto": _sparse.sparse_addto,
           "fused_fold": fused_gpv.fused_fold,
           "sat_add": inc_agg.sat_add,
           "sat_add_batch": inc_agg.sat_add_batch,
           "quantize": _quantize.quantize,
           "dequantize": _dequantize.dequantize,
           "flash_attention": _flash.flash_attention,
           "flash_bwd_delta": _flash.flash_bwd_delta,
           "flash_bwd_dkdv": _flash.flash_bwd_dkdv,
           "flash_bwd_dq": _flash.flash_bwd_dq,
           "pack_int8": _pack.pack_int8,
           "unpack_int8": _pack.unpack_int8}
# the two wrappers of the ordered scatter (csrc/scatter.cuh), which also
# count their launches per lane and record each launch's k
SCATTERS = ("sparse_addto", "fused_scatter")


def launch_counts() -> dict[str, int]:
    """Kernel launches on the card per wrapper since the last reset."""
    return {k: fn.launches for k, fn in KERNELS.items()}


def plain_counts() -> dict[str, int]:
    """Calls each wrapper sent to its plain version (CPU tensors)."""
    return {k: fn.plain_calls for k, fn in KERNELS.items()}


def lane_counts() -> dict[str, dict[str, int]]:
    """Launches per lane of the two scatter kernels since the last reset."""
    return {k: dict(KERNELS[k].lanes) for k in SCATTERS}


def launch_ks() -> dict[str, list[int]]:
    """The k (updates) of each scatter launch since the last reset (the
    latest ``sparse_addto.KS_KEPT`` of them)."""
    return {k: list(KERNELS[k].ks) for k in SCATTERS}


def reset_counts() -> None:
    with build.COUNT_LOCK:
        for fn in KERNELS.values():
            fn.launches = 0
            fn.plain_calls = 0
        for k in SCATTERS:
            KERNELS[k].lanes = dict.fromkeys(KERNELS[k].lanes, 0)
            KERNELS[k].ks.clear()


# -- numpy host kernels (the CPU switch's host segments) ----------------------

def fold_stream_host(logical: np.ndarray, vals: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Fold a duplicate-keyed update stream into per-key aggregates.

    Returns ``(keys, counts, sums)`` where ``keys`` holds each distinct
    address in FIRST-OCCURRENCE order (the order ``Counter.update(stream)``
    would insert them — the INC-map LRU breaks most_common ties by that
    insertion order, so the fold must preserve it), ``counts`` the number
    of occurrences, and ``sums`` the per-key value totals (``None`` when
    ``vals`` is ``None``).

    Already-strictly-increasing streams (the dense tensor-index case) skip
    the sort entirely.
    """
    logical = np.asarray(logical)
    n = len(logical)
    if n == 0:
        empty = np.zeros(0, logical.dtype if logical.dtype.kind in "iu"
                         else np.int64)
        return empty, np.zeros(0, np.int64), \
            (np.zeros(0, np.int64) if vals is not None else None)
    if vals is not None:
        vals = np.asarray(vals, np.int64)
    if n == 1 or bool((np.diff(logical.astype(np.int64)) > 0).all()):
        return logical, np.ones(n, np.int64), vals
    uniq, first, inv, cnt = np.unique(logical, return_index=True,
                                      return_inverse=True,
                                      return_counts=True)
    order = np.argsort(first, kind="stable")
    sums = None
    if vals is not None:
        sums = np.zeros(len(uniq), np.int64)
        np.add.at(sums, inv, vals)
        sums = sums[order]
    return uniq[order], cnt[order].astype(np.int64), sums


def fold_rounds(qrounds: list[np.ndarray]) -> np.ndarray:
    """Fold N quantized addTo rounds into one switch-bound update: one
    exact int64 reduction over the stacked rounds (client-side local
    aggregation, ``Agg[...](local_accum=N)``)."""
    if len(qrounds) == 1:
        return np.asarray(qrounds[0], np.int64)
    return np.add.reduce(np.stack([np.asarray(q, np.int64)
                                   for q in qrounds]), axis=0)


def device_fold_rounds(frounds: list, scale,
                       device: torch.device) -> torch.Tensor:
    """Quantize N fp32 addTo rounds and fold them with the switch's
    saturating add in ONE fused kernel launch on ``device`` (the caller's
    switch) — the ``device=True`` lane of ``local_accum``. Returns the
    folded int32 stream on ``device``; a round that saturates leaves the
    sentinel, where the host lane's ``fold_rounds`` keeps the exact sum."""
    fstack = np.stack([np.asarray(f, np.float32).reshape(-1)
                       for f in frounds])
    return fused_gpv.fused_fold(torch.from_numpy(fstack).to(device), scale)


def dense_addto_host(regs: np.ndarray, start: int,
                     val: np.ndarray) -> np.ndarray:
    """Saturating add of a contiguous update run — result-identical to
    ``sparse_addto_host(regs, arange(start, start+len(val)), val)`` but
    slice arithmetic instead of fancy gather/scatter. MUTATES ``regs`` in
    place and returns it."""
    n = len(val)
    if n == 0:
        return regs
    cur = regs[start:start + n].astype(np.int64)
    val = np.asarray(val, np.int64)
    safe = np.abs(cur) + np.abs(val) <= SAT_MAX
    new = cur + np.where(safe, val, 0)
    for i in np.nonzero(~safe)[0]:
        new[i] = _sat_add_scalar(int(cur[i]), int(val[i]))
    regs[start:start + n] = new.astype(np.int32)
    return regs


def sparse_addto_host(regs: np.ndarray, idx: np.ndarray,
                      val: np.ndarray) -> np.ndarray:
    """Numpy sparse_addto, result-identical to the sequential oracle;
    MUTATES ``regs`` in place and returns it.

    A slot for which |reg| + sum|val| stays within the SAT range can never
    produce (or have started from) a sentinel at any prefix of the update
    stream, so its updates collapse to one segment-sum; only updates to
    the remaining slots run the exact scalar loop.
    """
    idx = np.asarray(idx, np.int64)
    val = np.asarray(val, np.int64)
    if len(idx) == 0:
        return regs
    if len(idx) == 1 or bool((np.diff(idx) > 0).all()):
        # strictly increasing => every slot gets exactly ONE update, so the
        # sequential order is vacuous: a masked saturating add
        cur = regs[idx].astype(np.int64)
        safe = np.abs(cur) + np.abs(val) <= SAT_MAX
        new = cur + np.where(safe, val, 0)
        for i in np.nonzero(~safe)[0]:
            new[i] = _sat_add_scalar(int(cur[i]), int(val[i]))
        regs[idx] = new.astype(np.int32)
        return regs
    touched = np.unique(idx)
    pos = np.searchsorted(touched, idx)     # update -> touched-slot index
    cur = regs[touched].astype(np.int64)
    abs_sum = np.zeros(len(touched), np.int64)
    np.add.at(abs_sum, pos, np.abs(val))
    safe = np.abs(cur) + abs_sum <= SAT_MAX         # -SAT_MIN == SAT_MAX
    safe_upd = safe[pos]
    sums = np.zeros(len(touched), np.int64)
    np.add.at(sums, pos[safe_upd], val[safe_upd])
    new = cur + sums
    for i in np.nonzero(~safe_upd)[0]:      # exact order where it matters
        t = pos[i]
        new[t] = _sat_add_scalar(int(new[t]), int(val[i]))
    regs[touched] = new.astype(np.int32)
    return regs


# -- dispatchers --------------------------------------------------------------

def zeros_regs(n_slots: int, device: torch.device, resident: bool = False):
    """A fresh register segment: an int32 tensor on a CUDA switch or when
    the segment is device-resident, numpy on a CPU switch's host lane."""
    if resident or device.type != "cpu":
        return torch.zeros(n_slots, dtype=torch.int32, device=device)
    return np.zeros(n_slots, np.int32)


def _on(regs: torch.Tensor, x, dtype) -> torch.Tensor:
    """``x`` (numpy or tensor) as a contiguous tensor on regs' device. A
    numpy array that is not writeable (a view of a wire op's reassembled
    bytes) is copied first: a tensor must not share read-only memory."""
    if isinstance(x, torch.Tensor):
        return x.to(device=regs.device, dtype=dtype).contiguous()
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x).to(device=regs.device, dtype=dtype)


def _check_slots(idx, n_slots: int) -> None:
    idx = np.asarray(idx)
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n_slots):
        raise IndexError(f"slot index outside the {n_slots}-slot segment")


def sparse_addto(regs, idx, val):
    """Sequential saturating scatter-add of (idx, val) pairs into regs.

    numpy ``regs``: the exact host kernel, in place when writable. Tensor
    ``regs``: the sparse_addto kernel wrapper, in place. Callers treat the
    return value as the new register file either way.
    """
    if isinstance(regs, np.ndarray):
        if not regs.flags.writeable:
            regs = np.array(regs, np.int32)
        return sparse_addto_host(regs, np.asarray(idx), np.asarray(val))
    _check_slots(idx, regs.numel())
    return _sparse.sparse_addto(regs, _on(regs, idx, torch.int32),
                                _on(regs, val, torch.int32))


def sparse_addto_bucketed(regs, idx, val):
    """sparse_addto that skips an empty stream. (The reference pads the
    device stream to power-of-two buckets to bound its jit cache; eager
    kernels need no padding.)"""
    if len(idx) == 0:
        return regs
    return sparse_addto(regs, idx, val)


# -- device-resident GPV lane -------------------------------------------------
#
# These serve core/inc_map.py:DeviceSegment, whose regs are always a
# tensor: the kernel on the card, the plain version on the CPU.

def device_addto_dense(regs: torch.Tensor, start: int, fvals,
                       scale) -> torch.Tensor:
    """Fused quantize + saturating add of an fp32 stream over the
    contiguous slot range [start, start+len)."""
    if len(fvals) == 0:
        return regs
    return fused_gpv.fused_addto(regs, start,
                                 _on(regs, fvals, torch.float32), scale)


def device_addto_dense_runs(runs, fvals, scale) -> None:
    """``device_addto_dense`` of several runs, each ``(regs, start, foff,
    n)``: slots [start, start+n) of its own segment's ``regs`` take
    ``fvals[foff:foff+n]``. The part of ``fvals`` (numpy or tensor) that
    the runs read goes to the device in one copy, and the runs in one
    launch per ``fused_gpv.MAX_RUNS``; ``regs`` are updated in place."""
    runs = [r for r in runs if r[3]]
    if not runs:
        return
    lo = min(r[2] for r in runs)
    hi = max(r[2] + r[3] for r in runs)
    fdev = _on(runs[0][0], fvals[lo:hi], torch.float32)
    fused_gpv.fused_addto_runs([(regs, start, foff - lo, n)
                                for regs, start, foff, n in runs],
                               fdev, scale)


def device_addto_scatter(regs: torch.Tensor, idx, fvals,
                         scale) -> torch.Tensor:
    """Fused quantize + ordered saturating scatter-add of an fp32 stream;
    duplicate addresses accumulate in stream order, exactly like the host
    sequential oracle."""
    if len(idx) == 0:
        return regs
    _check_slots(idx, regs.numel())
    return fused_gpv.fused_scatter(regs, _on(regs, idx, torch.int32),
                                   _on(regs, fvals, torch.float32), scale)


def device_addto_int(regs: torch.Tensor, idx, vals) -> torch.Tensor:
    """Saturating scatter-add of an already-quantized int32 stream into a
    device register file — the int lane of a DeviceSegment (spill
    restores, clear write-backs, host-quantized fallbacks)."""
    return sparse_addto_bucketed(regs, idx, vals)


def device_read_dense(regs: torch.Tensor, start: int, n: int, scale
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gather + dequantize of slots [start, start+n) -> (fp32
    values, bool overflow-sentinel mask), both on regs' device."""
    return fused_gpv.fused_read(regs, start, n, scale)


def device_read_dense_runs(runs, m: int, scale, want_raw: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor | None]:
    """The fused gather + dequantize of several runs ``(regs, start, off,
    n)``, each from its own device register file, into one reply of ``m``
    values (run r at [off, off+n)): (fp32 values, bool overflow-sentinel
    mask, int32 raw registers when ``want_raw``), on the regs' device; one
    launch per run table."""
    return fused_gpv.fused_read_runs(runs, m, scale, want_raw=want_raw)


# -- stream verbs of the SyncAgtr path and the clear policies -----------------

def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """fp32 -> int32 fixed point with sentinel saturation (any shape)."""
    return _quantize.quantize(x.contiguous(), scale)


def dequantize(q: torch.Tensor, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 -> (fp32, bool overflow mask) (any shape)."""
    return _dequantize.dequantize(q.contiguous(), scale)


def sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 saturating add with sticky sentinels (a Map.addTo hop)."""
    return inc_agg.sat_add(a.contiguous(), b.contiguous())


def sat_add_batch(acc: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Fold a stacked batch of updates into ``acc`` in one launch,
    result-identical to ``for q in qs: acc = sat_add(acc, q)``. ``qs``
    has one extra leading dim over ``acc``, or none (a single update)."""
    if qs.dim() == acc.dim():
        return sat_add(acc, qs)
    if qs.shape[0] == 1:
        return sat_add(acc, qs[0])
    return inc_agg.sat_add_batch(acc.contiguous(), qs.contiguous())


# -- attention ----------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """(B,S,H,D) x (B,S,KV,D) -> (B,S,H,D) flash attention. The kernel
    reads this layout through its strides, where the reference swaps axes
    to (B,H,S,D) for the Pallas kernel."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


# -- the int8 wire format -----------------------------------------------------

def pack_int8(x: torch.Tensor, block_rows: int = DEFAULT_BLOCK_ROWS
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (n,) -> (int8 (rows, 128), fp32 scales (rows,)): the stream
    padded with zeros to whole (block_rows, 128) tiles, as the reference
    pads it, so both return the same shapes. The caller keeps n to
    truncate after ``unpack_int8``."""
    x = x.reshape(-1).to(torch.float32)
    tile = block_rows * LANES
    pad = (-x.shape[0]) % tile
    t = torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()
    return _pack.pack_int8(t.reshape(-1, LANES))


def unpack_int8(q: torch.Tensor, scale: torch.Tensor, n: int,
                block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """(int8 tiles, scales, n) -> fp32 (n,)."""
    if q.shape[0] % block_rows:
        raise ValueError(f"{q.shape[0]} rows are not whole tiles of "
                         f"{block_rows}")
    return _pack.unpack_int8(q.contiguous(),
                             scale.contiguous()).reshape(-1)[:n]

"""Sparse saturating scatter-add into the INC register file.

The int lane of the switch memory: a batch of (slot, int32 value) pairs
accumulated into a register segment in stream order, so duplicate slots
saturate exactly like the sequential oracle. On the card it is the
hand-written kernel of ``csrc/sparse_addto.cu`` (replacing the TPU kernel
``repro/kernels/sparse_addto.py:sparse_addto_pallas``); a CPU tensor takes
the plain version. The wrapper updates ``regs`` in place and returns it.

The kernel has two lanes (``csrc/scatter.cuh``): a call within
``cluster_limits()`` (every segment of the path) is one launch of
thread-block clusters whose scratch stays in their shared memory; a
larger one takes five launches over a scratch that the wrapper
allocates. ``launch_scatter`` serves ``fused_gpv.fused_scatter`` too.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {"repro_sparse_addto": (_P, _I, _P, _P, _I, _P, _P, _P),
              "repro_scatter_limits": (_P,),
              "repro_sparse_addto_ready": (_P,)}
LANES = ("cluster", "large")
KS_KEPT = 1 << 16       # the k of this many latest launches is kept
_LIMITS: dict[str, int] = {}


def check_scatter_args(regs: torch.Tensor, idx: torch.Tensor,
                       val: torch.Tensor, val_dtype: torch.dtype) -> None:
    """Device, dtype, shape and contiguity checks of a scatter launch."""
    if regs.dtype != torch.int32 or regs.dim() != 1:
        raise TypeError("regs must be a 1-D int32 tensor")
    if idx.dtype != torch.int32 or val.dtype != val_dtype:
        raise TypeError(f"idx must be int32 and values {val_dtype}")
    if idx.shape != val.shape or idx.dim() != 1:
        raise ValueError("idx and values must be 1-D of one length")
    if not (regs.device == idx.device == val.device):
        raise ValueError("regs, idx and values must share one device")
    if regs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for {regs.device.type} tensors")
    if not (regs.is_contiguous() and idx.is_contiguous()
            and val.is_contiguous()):
        raise ValueError("regs, idx and values must be contiguous")


def cluster_limits() -> dict[str, int]:
    """The scatter's lane limits, as ``csrc/scatter.cuh`` defines them: a
    call with at most ``max_slots`` slots and ``max_k`` updates takes the
    cluster lane (one launch of ``clusters`` clusters of ``ctas`` CTAs of
    ``threads`` threads, at most ``smem_bytes`` of dynamic shared memory
    each), a larger one the large lane. Read from the kernel library
    (built first if needed)."""
    if not _LIMITS:
        out = (ctypes.c_int64 * 6)()
        build.load("sparse_addto", SIGNATURES).repro_scatter_limits(out)
        _LIMITS.update(zip(("max_slots", "max_k", "ctas", "clusters",
                            "threads", "smem_bytes"), (int(x) for x in out)))
    return _LIMITS


def scatter_lane(n_slots: int, k: int) -> str:
    """The lane a scatter of ``k`` updates into ``n_slots`` slots takes."""
    lim = cluster_limits()
    return ("cluster" if n_slots <= lim["max_slots"] and k <= lim["max_k"]
            else "large")


def resident_clusters(device: torch.device) -> int:
    """How many clusters of the scatter kernel ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters`` at its largest launch, the check
    the kernel's first launch makes); raises if the query fails or none
    can be resident."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build.load("sparse_addto", SIGNATURES).repro_sparse_addto_ready(
            ctypes.byref(n))
    if err or n.value < 1:
        raise RuntimeError(f"no cluster of the scatter kernel can be "
                           f"resident on {device} (CUDA error {err}, "
                           f"{n.value} clusters)")
    return n.value


def scatter_scratch(regs: torch.Tensor, k: int):
    """Scratch of one launch on the large lane: 2 * n_slots + 1 int64 words
    (per-slot mass and sum, and the unsafe count; the kernel zeroes them)
    and k flag bytes. The cluster lane keeps its scratch on chip."""
    words = torch.empty(2 * regs.numel() + 1, dtype=torch.int64,
                        device=regs.device)
    unsafe = torch.empty(k, dtype=torch.uint8, device=regs.device)
    return words, unsafe


def launch_scatter(wrapper, lib: str, signatures: dict, fn: str,
                   regs: torch.Tensor, k: int, *args) -> None:
    """Launch the scatter kernel ``fn`` of ``lib`` (its arguments ``args``
    up to the scratch pointers) on the lane its size takes, and count it on
    ``wrapper``: ``launches``, ``lanes`` and the ``ks`` of its launches.
    The kernel's first cluster launch on a device checks that a cluster
    can be resident and fails the launch (which raises) if not."""
    lane = scatter_lane(regs.numel(), k)
    with torch.cuda.device(regs.device):
        if lane == "cluster":
            build.launch(lib, signatures, fn, *args, None, None)
        else:
            words, unsafe = scatter_scratch(regs, k)
            build.launch(lib, signatures, fn, *args, words.data_ptr(),
                         unsafe.data_ptr())
    with build.COUNT_LOCK:
        wrapper.launches += 1
        wrapper.lanes[lane] += 1
        wrapper.ks.append(k)


def sparse_addto_plain(regs: torch.Tensor, idx: torch.Tensor,
                       val: torch.Tensor) -> torch.Tensor:
    """The plain version: ``ref.sparse_addto`` (in place)."""
    return ref.sparse_addto(regs, idx, val)


def sparse_addto(regs: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """regs: int32 (n_slots,), idx: int32 (k,) in [0, n_slots), val: int32
    (k,). Applies regs[idx[i]] = sat_add(regs[idx[i]], val[i]) in stream
    order, IN PLACE, and returns ``regs``."""
    check_scatter_args(regs, idx, val, torch.int32)
    if regs.device.type == "cpu":
        build.count(sparse_addto, "plain_calls")
        return sparse_addto_plain(regs, idx, val)
    k = idx.numel()
    if k == 0:
        return regs
    launch_scatter(sparse_addto, "sparse_addto", SIGNATURES,
                   "repro_sparse_addto", regs, k, regs.data_ptr(),
                   regs.numel(), idx.data_ptr(), val.data_ptr(), k)
    return regs


sparse_addto.launches = 0       # kernel launches on the card
sparse_addto.lanes = dict.fromkeys(LANES, 0)    # launches per lane
sparse_addto.ks = collections.deque(maxlen=KS_KEPT)   # k of each launch
sparse_addto.plain_calls = 0    # CPU tensors sent to the plain version

"""The INC map: keys -> 32-bit logical addresses -> switch physical registers.

Paper §5.2.2. The RPCLayer sees an unlimited global map addressable by keys;
the INCLayer realizes it with:

  - client-side hashing of arbitrary keys into a 32-bit logical space,
    collisions detected by the client and routed to the host path;
  - a server-agent-owned logical->physical mapping (shared by all clients of
    an app, handed out by piggybacking on ACKs);
  - fixed-size on-switch register segments (here: device int32 arrays,
    updated with the saturating sparse_addto kernel);
  - cache replacement at the server agent (periodic-counting LRU — the
    paper's policy — plus FCFS / HASH / PoN baselines of Fig. 12);
  - host-side spill for unmapped keys (the fallback that makes the map
    "unlimited").

On the card the "switch memory" is a set of int32 CUDA tensors and this
module is the host-side control plane that decides which logical addresses
deserve a physical slot. The data-plane updates themselves
(kernels/sparse_addto.py, kernels/fused_gpv.py) run on the device.

GPV wire path (array-native tensors).  Every per-element Python loop on the
update/read path is gone: the logical->physical mapping and the host spill
keep lazily-rebuilt sorted-array snapshots (invalidated by a version counter
on the backing dicts), so ``addto_batch``/``read_batch`` are one
``searchsorted`` + one kernel batch regardless of how many RPC calls
contributed; per-window LRU usage counters accumulate as folded
(keys, counts) array chunks and materialize into the legacy ``Counter`` only
when a decision actually needs it; and ``ClientAgent`` resolves dense tensor
indices (identity hash) through a cached arange table instead of a dict
lookup per element.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs import hooks as _obs
from repro_torch.obs import trace as _trace

LOGICAL_BITS = 32
CACHE_POLICIES = ("netrpc-lru", "fcfs", "hash", "pon")


def hash_key(key: str | bytes | int) -> int:
    """Stable 32-bit logical address for an arbitrary key."""
    if isinstance(key, int):
        return key & 0xFFFFFFFF
    if isinstance(key, str):
        key = key.encode()
    return zlib.crc32(key) & 0xFFFFFFFF


# -- vectorized fixed-point quantization (the GPV value path) -----------------

def quantize_scalar_ref(values, scale) -> list[int]:
    """The pre-GPV per-element quantization, kept as the semantic oracle:
    ``int(round(v * scale))`` (ints pass through unscaled at scale 1).
    The vectorized path below must stay element-exact against this — the
    property tests in tests/test_wire_path.py pin it across signs,
    halfway cases, and precisions 0-8."""
    if scale == 1:
        return [v if type(v) is int else int(round(v)) for v in values]
    return [int(round(v * scale)) for v in values]


def quantize_stream(values: np.ndarray, scale) -> np.ndarray:
    """Vectorized fixed-point quantization of a numeric value stream:
    int64 ``rint(v * scale)``.

    Element-exact vs :func:`quantize_scalar_ref`: ``np.rint`` and Python's
    ``round`` both round half to even, and the multiply keeps the input's
    dtype so promotion matches the scalar path (a float32 stream is scaled
    in float32 either way). Integer streams skip the float detour
    entirely (``np.rint`` would otherwise promote them to float64).
    """
    arr = np.asarray(values)
    if arr.dtype.kind in "biu":
        if arr.dtype.kind == "u" and len(arr) \
                and int(arr.max()) > 2 ** 63 - 1:
            raise OverflowError("value exceeds int64 fixed-point range")
        arr = arr.astype(np.int64)
        if scale == 1:
            return arr
        lim = (2 ** 63 - 1) // int(scale)
        if len(arr) and (int(arr.max()) > lim or int(arr.min()) < -lim):
            # the scalar oracle raised OverflowError converting the exact
            # product to int64; wrapping silently would corrupt aggregates
            raise OverflowError(
                f"fixed-point product exceeds int64 at scale={scale}")
        return arr * int(scale)
    y = np.rint(arr * scale)
    if not np.isfinite(y).all():
        # stay as loud as the scalar oracle: int(round(x*s)) raises on
        # NaN/inf (e.g. a float16 stream whose product overflows in the
        # input dtype) — silently emitting int64-min garbage here would
        # corrupt aggregates instead
        if np.isnan(y).any():
            raise ValueError("cannot quantize NaN values to fixed point")
        raise OverflowError(
            "fixed-point quantization overflowed the value dtype "
            f"({arr.dtype} * scale={scale} is non-finite); widen the "
            "tensor dtype or lower the precision")
    if len(y) and (float(y.max()) >= 2.0 ** 63 or float(y.min()) < -2.0 ** 63):
        # finite but beyond int64: astype would wrap where the scalar
        # oracle's int() conversion raised
        raise OverflowError(
            f"fixed-point product exceeds int64 at scale={scale}")
    return y.astype(np.int64)


def quantize_values(values, scale) -> np.ndarray:
    """``quantize_stream`` when the values pack into a numeric ndarray,
    the scalar oracle otherwise (heterogeneous dict payloads, or a mixed
    int/float list whose float64 coercion would silently round an exact
    int above 2**53 that the scalar path kept exact)."""
    if isinstance(values, np.ndarray):
        arr = values
    else:
        values = list(values)
        try:
            arr = np.asarray(values)
        except (TypeError, ValueError):
            arr = None
        if arr is not None and arr.dtype.kind == "f" \
                and any(type(v) is int and abs(v) > 2 ** 53
                        for v in values):
            arr = None
    if arr is not None and arr.dtype.kind in "biuf":
        return quantize_stream(arr, scale)
    return np.array(quantize_scalar_ref(values, scale), np.int64)


# -- version-counted dicts (snapshot invalidation) ----------------------------

class _VersionedDict(dict):
    """dict that bumps ``.version`` on every mutation, so the sorted-array
    lookup snapshots invalidate correctly even when tests poke entries
    directly."""

    __slots__ = ("version",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.version = 0

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.version += 1

    def __delitem__(self, k):
        super().__delitem__(k)
        self.version += 1

    def pop(self, *a):
        self.version += 1
        return super().pop(*a)

    def popitem(self):
        self.version += 1
        return super().popitem()

    def clear(self):
        self.version += 1
        super().clear()

    def update(self, *a, **kw):
        self.version += 1
        super().update(*a, **kw)

    def setdefault(self, k, d=None):
        self.version += 1
        return super().setdefault(k, d)

    def __ior__(self, other):
        self.version += 1
        return super().__ior__(other)


class _SpillMap(_VersionedDict):
    """_VersionedDict with ``defaultdict(int)`` read semantics (the
    host-side spill map backing the vectorized ``read_batch`` snapshot);
    the missing-key insert routes through the version-bumping
    ``__setitem__``."""

    def __missing__(self, k):
        self[k] = 0
        return 0


@dataclass
class Segment:
    """One switch register segment (paper: 40K 32-bit units per segment).

    ``regs`` is a numpy array on a CPU switch's host lane and an int32
    tensor otherwise (every segment of a CUDA switch).

    ``lock`` stripes the switch memory per segment (the sharded-plane
    concurrency unit): two channels whose partitions live in different
    segments update registers fully in parallel; only co-resident
    partitions serialize, and only for the duration of one kernel batch.
    The read-modify-write of ``regs`` (an in-place kernel update) must be
    atomic per segment or concurrent batches lose updates.
    """
    n_slots: int
    regs: np.ndarray | torch.Tensor = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    # class attr, not a dataclass field: flipped by promotion (see
    # DeviceSegment) without changing the constructor signature
    device = False

    def __post_init__(self):
        if self.regs is None:
            self.regs = np.zeros(self.n_slots, np.int32)


@dataclass
class DeviceSegment(Segment):
    """A register segment whose ``regs`` are an int32 tensor for its whole
    lifetime: its fp32 updates and reads run the fused kernels
    (ops.device_addto_* / device_read_dense) and reads hand back tensors
    on the switch's device without a host round trip. Host segments are
    *promoted* in place (``__class__`` rewrite under ``lock`` — identity
    and lock object are preserved, so in-flight lock holders and
    cross-references stay valid)."""
    device = True

    def __post_init__(self):
        if self.regs is None:
            self.regs = torch.zeros(self.n_slots, dtype=torch.int32)
        elif not isinstance(self.regs, torch.Tensor):
            self.regs = torch.from_numpy(np.array(self.regs, np.int32))


class SwitchMemory:
    """The device-resident register file, partitioned among applications.

    Matches §6.1: 32 segments x 40K 32-bit units by default. Partitions are
    reserved per GAID at registration (FCFS), actual slots allocated lazily.

    ``device`` (default: the card) holds every segment as an int32 CUDA
    tensor, whose updates run the hand-written kernels. ``device="cpu"``
    keeps host segments as numpy arrays (the exact numpy host kernels) and
    device-resident segments as CPU tensors (the kernels' plain versions).
    """

    def __init__(self, n_segments: int = 32, seg_slots: int = 40_000,
                 device=None):
        self.device = resolve_device(device)
        self.n_segments = n_segments
        self.seg_slots = seg_slots
        self.segments = [Segment(seg_slots,
                                 ops.zeros_regs(seg_slots, self.device))
                         for _ in range(n_segments)]
        self.partitions: dict[int, tuple[int, int]] = {}  # gaid -> (start, n)
        self._next_free = 0
        self._alloc_lock = threading.Lock()   # reserve/release bookkeeping

    @property
    def total_slots(self) -> int:
        return self.n_segments * self.seg_slots

    def reserve(self, gaid: int, n_slots: int, device: bool = False) -> bool:
        """FCFS partition reservation at app registration (§5.2.2).

        ``device=True`` additionally promotes every segment the partition
        touches to device residency (idempotent; a segment shared with a
        host partition still serves that partition — the int paths work on
        both flavors)."""
        with self._alloc_lock:
            if gaid in self.partitions:
                if device:
                    self._promote(*self.partitions[gaid])
                return True
            if self._next_free + n_slots > self.total_slots:
                return False
            self.partitions[gaid] = (self._next_free, n_slots)
            self._next_free += n_slots
            if device:
                self._promote(self._next_free - n_slots, n_slots)
            return True

    def _promote(self, start: int, n_slots: int) -> None:
        """Make every segment covering physical range [start, start+n)
        device-resident, in place (caller holds _alloc_lock)."""
        if n_slots <= 0:
            return
        lo = start // self.seg_slots
        hi = (start + n_slots - 1) // self.seg_slots
        for s in range(lo, hi + 1):
            seg = self.segments[s]
            with seg.lock:
                if not seg.device:
                    seg.__class__ = DeviceSegment
                    seg.regs = self._tensor(seg.regs)

    def release(self, gaid: int) -> None:
        # partitions are compacted lazily; released ranges are re-usable
        # only at the tail (switch memory cannot be defragmented at runtime)
        with self._alloc_lock:
            part = self.partitions.pop(gaid, None)
            if part and part[0] + part[1] == self._next_free:
                self._next_free = part[0]

    def _tensor(self, regs) -> torch.Tensor:
        """``regs`` (numpy or tensor) as an int32 tensor on this switch's
        device."""
        if isinstance(regs, torch.Tensor):
            return regs.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(np.array(regs, np.int32)).to(self.device)

    def state_dict(self) -> dict:
        """Portable snapshot of the whole register file + partition table:
        one int32 CPU tensor per segment. ``to_jax_state`` turns it into
        the JAX package's numpy layout."""
        with self._alloc_lock:
            partitions = dict(self.partitions)
            next_free = self._next_free
        regs = []
        for seg in self.segments:
            with seg.lock:
                if isinstance(seg.regs, torch.Tensor):
                    regs.append(seg.regs.to("cpu", copy=True))
                else:
                    regs.append(torch.from_numpy(seg.regs.copy()))
        return {"partitions": partitions, "next_free": next_free,
                "regs": regs, "n_segments": self.n_segments,
                "seg_slots": self.seg_slots}

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict()`` snapshot (regs as tensors or numpy
        arrays; ``from_jax_state`` converts a JAX package snapshot). Each
        segment keeps its residency: a tensor on a CUDA switch or a
        device-resident segment, numpy on a CPU switch's host lane."""
        if (state["n_segments"] != self.n_segments
                or state["seg_slots"] != self.seg_slots):
            raise ValueError(
                f"switch geometry mismatch: spool is "
                f"{state['n_segments']}x{state['seg_slots']}, this switch "
                f"is {self.n_segments}x{self.seg_slots}")
        with self._alloc_lock:
            self.partitions.clear()
            self.partitions.update(state["partitions"])
            self._next_free = state["next_free"]
        for seg, regs in zip(self.segments, state["regs"]):
            with seg.lock:
                if seg.device or self.device.type != "cpu":
                    seg.regs = self._tensor(regs).clone()
                elif isinstance(regs, torch.Tensor):
                    seg.regs = regs.to("cpu", torch.int32).numpy().copy()
                else:
                    seg.regs = np.array(regs, np.int32)

    def occupancy(self) -> list[dict]:
        """Per-Segment allocation snapshot for the observability exports
        (scheduling_report's ``"__switch__"`` section): how many of each
        segment's slots are covered by reserved partitions, and whether
        the segment is device-resident. Deliberately allocation-based —
        counting nonzero registers would force a device sync per
        DeviceSegment on every monitoring poll."""
        with self._alloc_lock:
            next_free = self._next_free
        out = []
        for i, seg in enumerate(self.segments):
            used = min(max(next_free - i * self.seg_slots, 0),
                       self.seg_slots)
            out.append({"segment": i, "slots": self.seg_slots,
                        "allocated": used, "device": bool(seg.device)})
        return out

    def _locate(self, phys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return phys // self.seg_slots, phys % self.seg_slots

    @staticmethod
    def _seg_groups(seg_ix: np.ndarray):
        """(segment, selector) pairs for a batch, in ascending segment
        order — a range scan between the min and max touched segment
        instead of an O(n log n) np.unique sort; a partition spans a
        handful of adjacent segments at most. A batch sorted by segment
        (a contiguous run of slots) gets one slice a segment."""
        mn, mx = int(seg_ix.min()), int(seg_ix.max())
        if mn == mx:
            yield mn, slice(None)
            return
        if bool((np.diff(seg_ix) >= 0).all()):
            cuts = np.searchsorted(seg_ix, np.arange(mn, mx + 2))
            for s in range(mn, mx + 1):
                lo, hi = int(cuts[s - mn]), int(cuts[s - mn + 1])
                if hi > lo:
                    yield s, slice(lo, hi)
            return
        for s in range(mn, mx + 1):
            m = seg_ix == s
            if m.any():
                yield s, m

    def addto(self, phys: np.ndarray, vals: np.ndarray) -> None:
        """Saturating scatter-add batches into the owning segments — one
        (bucketed) sparse_addto kernel launch per touched segment, however
        many RPC calls contributed to the batch."""
        seg_ix, off = self._locate(np.asarray(phys))
        if not len(seg_ix):
            return
        for s, m in self._seg_groups(seg_ix):
            seg = self.segments[s]
            with seg.lock:
                if seg.device:
                    seg.regs = ops.device_addto_int(
                        seg.regs, np.asarray(off[m], np.int32),
                        np.asarray(vals[m], np.int32))
                else:
                    seg.regs = ops.sparse_addto_bucketed(
                        seg.regs, np.asarray(off[m], np.int32),
                        np.asarray(vals[m], np.int32))

    def addto_dense(self, start: int, vals: np.ndarray) -> None:
        """Saturating add of a contiguous physical run — result-identical
        to ``addto(arange(start, start+len(vals)), vals)`` but without the
        address array on numpy host segments (per-segment slice
        arithmetic); tensor segments take the scatter lane."""
        n = len(vals)
        pos = 0
        while pos < n:
            s, off = divmod(start + pos, self.seg_slots)
            take = min(n - pos, self.seg_slots - off)
            seg = self.segments[s]
            v = np.asarray(vals[pos:pos + take], np.int32)
            with seg.lock:
                if (not seg.device and isinstance(seg.regs, np.ndarray)
                        and seg.regs.flags.writeable):
                    seg.regs = ops.dense_addto_host(seg.regs, off, v)
                else:       # tensor-backed segment: scatter lane
                    idx = np.arange(off, off + take, dtype=np.int32)
                    if seg.device:
                        seg.regs = ops.device_addto_int(seg.regs, idx, v)
                    else:
                        seg.regs = ops.sparse_addto_bucketed(seg.regs,
                                                             idx, v)
            pos += take

    def addto_f32(self, phys: np.ndarray, fvals: np.ndarray, scale) -> None:
        """Fused quantize + saturating scatter-add of an fp32 update
        stream — the device-resident transmit verb. Contiguous per-segment
        runs (the dense GPV tensor case) lower to one fused slice-add
        kernel; anything else (gaps, duplicates) to the fused serial
        scatter, which matches the sequential oracle exactly. Non-device
        segments quantize on host and take the int path (robustness only;
        the agent routes f32 streams here just for device partitions).

        The contiguous runs of several device segments go down together
        (``ops.device_addto_dense_runs``): one copy of their values and one
        launch, under the locks of all their segments, taken in ascending
        segment order (so two transmits cannot deadlock) and released in
        reverse. Every other segment takes only its own lock."""
        seg_ix, off = self._locate(np.asarray(phys))
        if not len(seg_ix):
            return
        fvals = np.asarray(fvals, np.float32)
        runs = []       # (segment, first slot, slots, selector): dense runs
        for s, m in self._seg_groups(seg_ix):
            seg = self.segments[s]
            o = np.asarray(off[m], np.int32)
            if seg.device and (len(o) == 1 or bool((np.diff(o) == 1).all())):
                runs.append((seg, int(o[0]), len(o), m))
                continue
            with seg.lock:
                if not seg.device:
                    seg.regs = ops.sparse_addto_bucketed(
                        seg.regs, o,
                        quantize_stream(fvals[m], scale).astype(np.int32))
                else:
                    seg.regs = ops.device_addto_scatter(
                        seg.regs, o, fvals[m], scale)
        if len(runs) == 1:
            seg, start, _, m = runs[0]
            with seg.lock:
                seg.regs = ops.device_addto_dense(seg.regs, start, fvals[m],
                                                  scale)
        elif runs:
            if all(isinstance(r[3], slice) for r in runs):
                stream, offs = fvals, [r[3].start for r in runs]
            else:       # a stream not sorted by segment: gather the runs
                stream = np.concatenate([fvals[r[3]] for r in runs])
                offs = np.cumsum([0] + [r[2] for r in runs[:-1]])
            with contextlib.ExitStack() as held:
                for r in runs:
                    held.enter_context(r[0].lock)
                ops.device_addto_dense_runs(
                    [(seg.regs, start, int(foff), n)
                     for (seg, start, n, _), foff in zip(runs, offs)],
                    stream, scale)

    def read_f32(self, phys: np.ndarray, scale, need_raw: bool = False
                 ) -> tuple[torch.Tensor, np.ndarray | None]:
        """Fused gather + dequantize read -> (fp32 values as a tensor on
        the switch's device, raw int registers as numpy when
        ``need_raw``). The single-segment contiguous case (a dense GPV
        tensor reply) is one fused kernel. A reply over several device
        segments, sorted by segment and contiguous within each, is one
        launch of the runs kernel (``ops.device_read_dense_runs``) and one
        copy of its raw registers to the host when ``need_raw``, under the
        locks of all its segments, taken in ascending segment order (as
        ``addto_f32`` takes them) and released in reverse. The general
        case gathers via ``get`` and dequantizes with the same reciprocal
        formula, so all flavors are bit-identical."""
        n = len(phys)
        if n == 0:
            empty_raw = np.zeros(0, np.int32) if need_raw else None
            return torch.zeros(0, dtype=torch.float32,
                               device=self.device), empty_raw
        seg_ix, off = self._locate(np.asarray(phys))
        if int(seg_ix[0]) == int(seg_ix[-1]):
            seg = self.segments[int(seg_ix[0])]
            o = np.asarray(off, np.int64)
            if seg.device and (n == 1 or bool((np.diff(o) == 1).all())):
                with seg.lock:
                    vals, _ = ops.device_read_dense(
                        seg.regs, int(o[0]), n, scale)
                    raw = None
                    if need_raw:
                        raw = seg.regs[int(o[0]):int(o[0]) + n].to(
                            "cpu", copy=True).numpy()
                return vals, raw
        else:
            runs = self._read_runs(seg_ix, off)
            if runs:
                with contextlib.ExitStack() as held:
                    for seg, *_ in runs:
                        held.enter_context(seg.lock)
                    vals, _, raw = ops.device_read_dense_runs(
                        [(seg.regs, start, pos, k)
                         for seg, start, pos, k in runs],
                        n, scale, want_raw=need_raw)
                    if need_raw:
                        raw = raw.cpu().numpy()
                return vals, raw
        raw = self.get(phys)
        inv = np.float32(1.0) / np.float32(scale)
        vals = torch.from_numpy(raw.astype(np.float32) * inv).to(self.device)
        return vals, (raw if need_raw else None)

    def _read_runs(self, seg_ix: np.ndarray, off: np.ndarray):
        """(segment, first slot, first position in the reply, slots) of
        each segment of a reply, in ascending segment order, when every
        segment is a device segment read in one contiguous run of slots
        and the reply is sorted by segment; else None."""
        runs = []
        for s, m in self._seg_groups(seg_ix):
            seg = self.segments[s]
            o = off[m]
            if not (seg.device and isinstance(m, slice)
                    and (len(o) == 1 or bool((np.diff(o) == 1).all()))):
                return None
            runs.append((seg, int(o[0]), m.start, len(o)))
        return runs

    def get(self, phys: np.ndarray) -> np.ndarray:
        # reads take the segment lock too: the host-path kernel updates
        # ``regs`` IN PLACE (kernels/ops.py:sparse_addto), so a lock-free
        # gather could see a torn mid-batch state of a co-resident
        # partition's update. Read-your-writes ordering still comes from
        # the channel plane lock; this only serializes against another
        # channel's in-flight kernel batch on a shared segment. A tensor
        # segment gathers on its device before the copy to the host.
        out = np.zeros(len(phys), np.int32)
        if not len(phys):
            return out
        seg_ix, off = self._locate(np.asarray(phys))
        for s, m in self._seg_groups(seg_ix):
            seg = self.segments[s]
            with seg.lock:
                if isinstance(seg.regs, torch.Tensor):
                    ix = torch.from_numpy(np.asarray(off[m], np.int64))
                    out[m] = seg.regs[ix.to(seg.regs.device)].cpu().numpy()
                else:
                    out[m] = seg.regs[off[m]]
        return out

    def clear(self, phys: np.ndarray) -> None:
        if not len(phys):
            return
        seg_ix, off = self._locate(np.asarray(phys))
        for s, m in self._seg_groups(seg_ix):
            seg = self.segments[s]
            with seg.lock:
                if isinstance(seg.regs, np.ndarray):  # host register file
                    seg.regs[off[m]] = 0
                else:
                    ix = torch.from_numpy(np.asarray(off[m], np.int64))
                    seg.regs[ix.to(seg.regs.device)] = 0


def from_jax_state(state: dict) -> dict:
    """A JAX package ``SwitchMemory.state_dict()`` (numpy regs) as this
    port's snapshot (int32 CPU tensors), ready for ``load_state``."""
    out = dict(state)
    out["partitions"] = dict(state["partitions"])
    out["regs"] = [torch.from_numpy(np.array(r, np.int32))
                   for r in state["regs"]]
    return out


def to_jax_state(state: dict) -> dict:
    """This port's ``state_dict()`` in the JAX package's layout (numpy
    regs), for ``repro.core.inc_map.SwitchMemory.load_state``."""
    out = dict(state)
    out["partitions"] = dict(state["partitions"])
    out["regs"] = [r.to("cpu", torch.int32).numpy().copy()
                   if isinstance(r, torch.Tensor) else np.array(r, np.int32)
                   for r in state["regs"]]
    return out


def _locked(fn):
    """Run an agent data-path method under the instance's re-entrant
    ``lock`` (one acquire per *batch* call, not per element)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self.lock:
            return fn(self, *a, **kw)
    return wrapper


class ServerAgent:
    """Owns the logical->physical mapping for one application (§5.2.2).

    Clients send unmapped keys to the server (host path); if switch memory
    is available the agent piggybacks a mapping on the returning ACK. The
    agent also runs the cache replacement policy over per-window client
    usage counters.
    """

    def __init__(self, switch: SwitchMemory, gaid: int, n_slots: int,
                 policy: str = "netrpc-lru", pon_threshold: int = 4,
                 window: int = 1024, device: bool = False):
        assert policy in CACHE_POLICIES, policy
        self.switch = switch
        self.gaid = gaid
        self.policy = policy
        self.pon_threshold = pon_threshold
        self.window = window
        # device-resident partition: f32 update/read streams take the
        # fused quantize/dequantize kernel lanes (addto_batch_f32 /
        # read_batch_dev) instead of host-quantizing first
        self.device = device
        # per-instance lock (sharded data plane): an agent belongs to one
        # channel, whose pipeline passes are already serialized by the
        # channel plane lock — this lock additionally makes direct agent
        # reads (stub.agents[m].read, benchmarks, telemetry) safe against
        # a drain running concurrently on another thread. Re-entrant:
        # data-path methods call each other (read -> read_batch).
        self.lock = threading.RLock()
        self.granted = switch.reserve(gaid, n_slots, device=device)
        self.base, self.capacity = (switch.partitions.get(gaid, (0, 0)))
        self.mapping: dict[int, int] = _VersionedDict()  # logical -> physical
        self.free: list[int] = list(range(self.capacity - 1, -1, -1))
        self.spill: dict[int, int] = _SpillMap()        # host-side values
        # per-window usage counters for the periodic LRU, accumulated as
        # folded (keys, counts) array chunks in stream order; the legacy
        # Counter view (``window_counts``) materializes lazily, preserving
        # first-occurrence insertion order so most_common tie-breaks are
        # unchanged
        self._win_chunks: list[tuple[np.ndarray, np.ndarray]] = []
        self._win_cache: Counter | None = None
        # dense-window watermark: while every chunk is a 0-based contiguous
        # index range (the GPV tensor regime), the window's distinct key
        # set is just arange(max chunk length) and end_window can decide
        # the no-op case in O(1)
        self._win_dense_max = 0
        self._win_mixed = False
        self.seen_this_window = 0
        # lazily-rebuilt sorted-array snapshots for the vectorized lookup
        self._map_snap = None
        self._spill_snap = None
        self._range_snap = None       # dense [0, L) -> slot lookup table
        # grants whose spilled value hasn't been migrated on-switch yet.
        # Reads stay exact while one is pending (read = spill + register and
        # the value sits in exactly one of the two); batching the migrations
        # turns per-new-key register writes into one addto per batch.
        self._pending_migrations: list[tuple[int, int]] = []
        # metrics
        self.hits = 0
        self.misses = 0
        self.inc_bytes = 0
        self.host_bytes = 0

    # -- snapshot plumbing ------------------------------------------------

    @property
    @_locked
    def window_counts(self) -> Counter:
        """Materialized per-window usage Counter (legacy view). Insertion
        order matches the old eager ``Counter.update(stream)``: chunks are
        appended in batch order and each chunk's keys are in
        first-occurrence order, so most_common ties break identically."""
        c = self._win_cache
        if c is None:
            c = Counter()
            for k, n in self._win_chunks:
                c.update(dict(zip(k.tolist(), n.tolist())))
            self._win_cache = c
        return c

    def _note_window(self, keys: np.ndarray, counts: np.ndarray,
                     total: int) -> None:
        self._win_chunks.append((keys, counts))
        self._win_cache = None
        n = len(keys)
        if n and not self._win_mixed:
            if int(keys[0]) == 0 and int(keys[-1]) == n - 1 \
                    and bool((np.diff(keys) == 1).all()):
                self._win_dense_max = max(self._win_dense_max, n)
            else:
                self._win_mixed = True
        self.seen_this_window += total

    def _clear_window(self) -> None:
        self._win_chunks = []
        self._win_cache = None
        self._win_dense_max = 0
        self._win_mixed = False
        self.seen_this_window = 0

    def _map_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted logical keys, aligned physical slots) snapshot of the
        mapping; rebuilt only when the mapping's version moved."""
        snap = self._map_snap
        if snap is None or snap[0] != self.mapping.version:
            if self.mapping:
                keys = np.fromiter(self.mapping.keys(), np.int64,
                                   len(self.mapping))
                slots = np.fromiter(self.mapping.values(), np.int64,
                                    len(self.mapping))
                order = np.argsort(keys, kind="stable")
                keys, slots = keys[order], slots[order]
            else:
                keys = slots = np.zeros(0, np.int64)
            snap = self._map_snap = (self.mapping.version, keys, slots)
        return snap[1], snap[2]

    def _spill_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        snap = self._spill_snap
        if snap is None or snap[0] != self.spill.version:
            if self.spill:
                keys = np.fromiter(self.spill.keys(), np.int64,
                                   len(self.spill))
                vals = np.fromiter(self.spill.values(), np.int64,
                                   len(self.spill))
                order = np.argsort(keys, kind="stable")
                keys, vals = keys[order], vals[order]
            else:
                keys = vals = np.zeros(0, np.int64)
            snap = self._spill_snap = (self.spill.version, keys, vals)
        return snap[1], snap[2]

    def _range_table(self, n: int) -> np.ndarray:
        """slot-or-minus-one lookup table over logical addresses [0, n) —
        the O(1)-per-element dense path (tensor indices ARE their own
        address, so a GPV batch's lookup is one fancy index instead of a
        searchsorted)."""
        snap = self._range_snap
        if snap is None or snap[0] != self.mapping.version or snap[1] < n:
            keys, slots = self._map_arrays()
            size = max(n, snap[1] if snap is not None else 0)
            tab = np.full(size, -1, np.int64)
            if len(keys):
                cut = int(np.searchsorted(keys, size))
                tab[keys[:cut]] = slots[:cut]
            snap = self._range_snap = (self.mapping.version, size, tab)
        return snap[2]

    def _map_lookup(self, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(hit mask, candidate slots) for an int64 logical-address batch —
        ONE searchsorted over the mapping snapshot (or one table index for
        a dense 0-based range), no per-key Python."""
        n = len(q)
        if n > 1 and int(q[0]) == 0 and int(q[-1]) == n - 1 \
                and bool((np.diff(q) == 1).all()):
            slotv = self._range_table(n)[:n]       # q == arange(n)
            return slotv >= 0, slotv
        keys, slots = self._map_arrays()
        if not len(keys):
            return np.zeros(n, bool), slots
        ix = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return keys[ix] == q, slots[ix]

    # -- data path ------------------------------------------------------

    @_locked
    def addto_batch(self, logical: np.ndarray, vals: np.ndarray) -> None:
        """Route a batch of (logical addr, value) updates: INC or host.
        Fully vectorized: one mapping lookup, one switch kernel batch for
        the hits, one folded spill/stats update for the misses, one folded
        usage chunk for the LRU window."""
        logical = np.asarray(logical, np.uint32)
        vals = np.asarray(vals, np.int64)
        n = len(logical)
        if n == 0:
            return
        t0_us = _trace.now_us() if _obs.TRACE else 0.0
        q = logical.astype(np.int64)
        hit, slotv = self._map_lookup(q)
        n_hit = int(hit.sum())
        # INC path
        if n_hit:
            if n_hit == n:
                phys, v32 = self.base + slotv, vals.astype(np.int32)
            else:
                phys, v32 = self.base + slotv[hit], vals[hit].astype(np.int32)
            self.switch.addto(phys, v32)
            self.hits += n_hit
            self.inc_bytes += n_hit * 8
        # host path (miss): server agent software map + maybe grant mapping
        if n_hit < n:
            miss = ~hit
            self._route_miss(logical[miss], vals[miss])
        self._account(logical, n)
        if _obs.TRACE:
            _obs.switch_op("addto", n, t0_us)

    def _route_miss(self, lmiss: np.ndarray, vmiss: np.ndarray) -> None:
        """Fold missed (logical, value) updates into the host spill and
        probe the grant policy once per distinct key. Duplicates fold to
        one spill write and one grant probe per key — behavior-identical
        to the per-occurrence loop because the window counters only
        advance after this batch, so every occurrence saw the same grant
        decision anyway."""
        n_miss = len(lmiss)
        keys_f, _, sums_f = ops.fold_stream_host(lmiss, vmiss)
        self.misses += n_miss
        self.host_bytes += 8 * n_miss
        spill = self.spill
        for l, v in zip(keys_f.tolist(), sums_f.tolist()):
            spill[l] += v
            self._maybe_grant(l)

    def _account(self, logical: np.ndarray, n: int) -> None:
        """Per-batch usage accounting for the periodic LRU + migration
        flush — the shared tail of the int and f32 addto lanes."""
        wkeys, wcnt, _ = ops.fold_stream_host(logical)
        self._note_window(wkeys, wcnt, n)
        if self.seen_this_window >= self.window:
            self.end_window()
        self._flush_migrations()

    @_locked
    def addto_batch_f32(self, logical: np.ndarray, fvals: np.ndarray,
                        scale) -> None:
        """The device-resident transmit lane: route an fp32 update stream
        so mapped addresses reach the switch *unquantized* and quantize
        inside the fused kernel; only misses (spill-bound) quantize
        on host. Stats/policy behavior is identical to
        ``addto_batch(logical, quantize_stream(fvals, scale))`` — which is
        exactly what a non-device agent falls back to."""
        if not self.device:
            self.addto_batch(logical,
                             quantize_stream(np.asarray(fvals), scale))
            return
        logical = np.asarray(logical, np.uint32)
        fvals = np.asarray(fvals, np.float32)
        n = len(logical)
        if n == 0:
            return
        t0_us = _trace.now_us() if _obs.TRACE else 0.0
        q = logical.astype(np.int64)
        hit, slotv = self._map_lookup(q)
        n_hit = int(hit.sum())
        if n_hit:
            if n_hit == n:
                phys, fv = self.base + slotv, fvals
            else:
                phys, fv = self.base + slotv[hit], fvals[hit]
            self.switch.addto_f32(phys, fv, scale)
            self.hits += n_hit
            self.inc_bytes += n_hit * 8
        if n_hit < n:
            miss = ~hit
            self._route_miss(logical[miss],
                             quantize_stream(fvals[miss], scale))
        self._account(logical, n)
        if _obs.TRACE:
            _obs.switch_op("addto_f32", n, t0_us)

    @_locked
    def read_batch_dev(self, logical: np.ndarray, scale,
                       need_raw: bool = False
                       ) -> tuple[torch.Tensor, np.ndarray | None]:
        """The device-resident receive lane: batched Map.get returning
        dequantized fp32 values as a tensor on the switch's device (plus
        the raw int64
        registers when the caller must write back a clear). The all-hit /
        no-spill case — the steady dense-tensor regime — is one fused
        gather+dequantize kernel; any spill or miss falls back to the
        exact int64 assembly of ``read_batch`` with the same reciprocal
        dequant formula, so both flavors agree bit-for-bit."""
        logical = np.asarray(logical, np.uint32)
        n = len(logical)
        if n == 0:
            raw = np.zeros(0, np.int64) if need_raw else None
            return torch.zeros(0, dtype=torch.float32,
                               device=self.switch.device), raw
        t0_us = _trace.now_us() if _obs.TRACE else 0.0
        q = logical.astype(np.int64)
        spill_hit = False
        if self.spill:
            skeys, _ = self._spill_arrays()
            ix = np.minimum(np.searchsorted(skeys, q), len(skeys) - 1)
            spill_hit = bool((skeys[ix] == q).any())
        if not spill_hit and self.mapping:
            hit, slotv = self._map_lookup(q)
            if bool(hit.all()):
                vals, raw32 = self.switch.read_f32(
                    self.base + slotv, scale, need_raw=need_raw)
                raw = raw32.astype(np.int64) if need_raw else None
                if _obs.TRACE:
                    _obs.switch_op("read_dev", n, t0_us)
                return vals, raw
        raw = self.read_batch(logical)
        inv = np.float32(1.0) / np.float32(scale)
        vals = torch.from_numpy(raw.astype(np.float32) * inv).to(
            self.switch.device)
        return vals, (raw if need_raw else None)

    @_locked
    def spill_host(self, pairs: list[tuple[int, int]]) -> None:
        """Batched host-path fold for collision-routed (logical, delta)
        pairs: ONE stats update + one folded spill write per flush instead
        of a Python loop per item (the host path of _MapOpBuffer.flush and
        ClientAgent.addto)."""
        if not pairs:
            return
        self.host_bytes += 8 * len(pairs)
        folded: Counter = Counter()
        for l, v in pairs:
            folded[l] += v
        spill = self.spill
        for l, v in folded.items():
            spill[l] += v

    def read(self, logical: int) -> int:
        """Map.get: switch register (if mapped) + host spill."""
        return int(self.read_batch(np.array([logical], np.uint32))[0])

    @_locked
    def read_batch(self, logical: np.ndarray) -> np.ndarray:
        """Batched Map.get: ONE switch gather for all mapped addresses plus
        the host-spill components — the data-plane read of call_batch.
        Spill and mapping lookups are searchsorted over the sorted-array
        snapshots (no per-key dict probes)."""
        logical = np.asarray(logical, np.uint32)
        n = len(logical)
        out = np.zeros(n, np.int64)
        if n == 0:
            return out
        t0_us = _trace.now_us() if _obs.TRACE else 0.0
        q = logical.astype(np.int64)
        if self.spill:
            skeys, svals = self._spill_arrays()
            ix = np.minimum(np.searchsorted(skeys, q), len(skeys) - 1)
            shit = skeys[ix] == q
            if shit.any():
                out[shit] = svals[ix[shit]]
        if self.mapping:
            hit, slotv = self._map_lookup(q)
            if hit.any():
                out[hit] += self.switch.get(
                    self.base + slotv[hit]).astype(np.int64)
        if _obs.TRACE:
            _obs.switch_op("read", n, t0_us)
        return out

    @_locked
    def read_all(self) -> dict[int, int]:
        out = dict(self.spill)
        if self.mapping:
            keys, slots = self._map_arrays()
            vals = self.switch.get(self.base + slots)
            for l, v in zip(keys.tolist(), vals.tolist()):
                out[l] = out.get(l, 0) + int(v)
        return out

    @_locked
    def clear_all(self) -> None:
        self._pending_migrations.clear()    # values below are wiped anyway
        if self.mapping:
            phys = self.base + np.array(list(self.mapping.values()))
            self.switch.clear(phys)
        self.spill.clear()

    # -- mapping policy ---------------------------------------------------

    def _maybe_grant(self, logical: int) -> None:
        if not self.granted or logical in self.mapping:
            return
        if self.policy == "hash":
            slot = logical % self.capacity if self.capacity else 0
            if self.capacity and slot not in self.mapping.values():
                self._install(logical, slot)
            return
        if self.policy == "pon":
            if self.window_counts[logical] + 1 < self.pon_threshold:
                return
            if self.free:
                self._install(logical, self.free.pop())
            return
        # fcfs and netrpc-lru both grant while space lasts; they differ in
        # eviction (fcfs never evicts; lru evicts at window end)
        if self.free:
            self._install(logical, self.free.pop())

    def _install(self, logical: int, slot: int) -> None:
        self.mapping[logical] = slot
        # migrate the host-spilled partial value into the register — queued
        # so a burst of grants becomes one switch.addto batch
        self._pending_migrations.append((logical, slot))

    def _flush_migrations(self) -> None:
        if not self._pending_migrations:
            return
        pending, self._pending_migrations = self._pending_migrations, []
        phys, vals = [], []
        for logical, slot in pending:
            if self.mapping.get(logical) != slot:
                continue                     # evicted/remapped while queued
            v = self.spill.pop(logical, 0)
            if v:
                phys.append(self.base + slot)
                vals.append(v)
        if phys:
            self.switch.addto(np.array(phys), np.array(vals, np.int32))

    @_locked
    def end_window(self) -> None:
        """Periodic counting-based LRU (§5.2.2): clients report per-window
        use counts; the agent evicts mapped keys colder than unmapped ones.

        Fast path for the steady dense-tensor regime: when the window's
        distinct keys fit the capacity (no most_common truncation) and no
        mapped key went cold, the whole window is a no-op — decided with
        two C-level set operations on the array chunks instead of a sort +
        Python scan over every counter."""
        self._flush_migrations()
        if self.policy == "netrpc-lru" and self.capacity:
            noop = False
            if self._win_chunks and not self._win_mixed:
                # dense regime: window keys == arange(watermark), so the
                # no-op test is two scalar compares
                w = self._win_dense_max
                if w <= self.capacity:
                    mkeys, _ = self._map_arrays()
                    noop = len(mkeys) == 0 or int(mkeys[-1]) < w
            elif self._win_chunks:
                wkeys = np.unique(np.concatenate(
                    [k.astype(np.int64) for k, _ in self._win_chunks]))
                if len(wkeys) <= self.capacity:
                    mkeys, _ = self._map_arrays()
                    noop = len(np.setdiff1d(mkeys, wkeys,
                                            assume_unique=True)) == 0
            if not noop:
                counts = self.window_counts
                hot = [l for l, _ in counts.most_common(self.capacity)]
                hot_set = set(hot)
                evict = [l for l in self.mapping if l not in hot_set]
                want = [l for l in hot if l not in self.mapping]
                for l in evict:
                    if not want:
                        break
                    slot = self.mapping.pop(l)
                    # retrieve the register value into the host map (no loss)
                    v = int(self.switch.get(np.array([self.base + slot]))[0])
                    if v:
                        self.spill[l] += v
                    self.switch.clear(np.array([self.base + slot]))
                    self._install(want.pop(0), slot)
        self._clear_window()
        self._flush_migrations()

    @_locked
    def retrieve_all(self) -> None:
        """Pull every mapped register value into the host-side map (the
        level-1 timeout retrieval of §5.2.2, also used at graceful stop):
        one switch gather + one clear for the whole mapping."""
        self._flush_migrations()
        if self.mapping:
            keys, slots = self._map_arrays()
            phys = self.base + slots
            vals = self.switch.get(phys).astype(np.int64)
            nz = vals != 0
            spill = self.spill
            for l, v in zip(keys[nz].tolist(), vals[nz].tolist()):
                spill[l] += v
            self.switch.clear(phys)
        self.mapping.clear()
        self.free = list(range(self.capacity - 1, -1, -1))

    # -- metrics ----------------------------------------------------------

    @property
    def cache_hit_ratio(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


class ClientAgent:
    """Client-side key hashing + collision detection (§5.2.2).

    The client knows its own key set, so it can detect logical-address
    collisions among them and route colliding keys via the host payload
    path (bypassing INC) — handled here by tracking a canonical key per
    logical address.

    Dense tensor indices (the GPV fast path) resolve through a cached
    arange table: index ``i`` hashes to logical address ``i`` (identity),
    so the table is valid for every index not claimed earlier by a
    *foreign* key (a key whose hash is not itself — strings, bytes,
    ints >= 2**32). Foreign claims are tracked as they happen, so
    extending the table to a larger tensor never scans ``key_of``; and
    once an index is canonical it stays canonical (ownership is
    first-writer-wins and permanent), so the table never invalidates.
    """

    def __init__(self, server: ServerAgent):
        self.server = server
        # per-instance lock: an agent serves one stub method, whose
        # pipeline passes the channel plane lock already serializes —
        # this guards the memoization tables when user threads call
        # ``read``/``logical`` directly while a drain is in flight
        self.lock = threading.RLock()
        self.key_of: dict[int, str | bytes | int] = {}
        self.collisions: dict[str | bytes | int, int] = {}
        self._addr: dict = {}          # key -> logical (or None): memoized
        # GPV dense-index table: indices [0, _dense_n) own their address
        # unless listed in _dense_coll (claimed first by a foreign key)
        self._dense_n = 0
        self._dense_log = np.zeros(0, np.uint32)
        self._dense_coll: list[int] = []
        self._dense_coll_arr = np.zeros(0, np.int64)
        self._foreign: dict[int, None] = {}   # addrs owned by foreign keys

    @_locked
    def logical(self, key) -> int | None:
        """Returns the logical address, or None if the key must bypass INC.

        Memoized: once a key is canonical for its hash it stays canonical,
        and a collision is permanent, so the cached answer never changes.
        """
        try:
            return self._addr[key]
        except KeyError:
            pass
        if key in self.collisions:
            l = None
        else:
            l = hash_key(key)
            if key != l and l < self._dense_n:
                # a dense tensor index claimed this address first
                self.collisions[key] = l
                self._addr[key] = None
                return None
            owner = self.key_of.setdefault(l, key)
            if owner != key:
                self.collisions[key] = l
                l = None
            elif key != l:
                self._foreign[l] = None
        self._addr[key] = l
        return l

    def _ensure_dense(self, n: int) -> None:
        if n <= self._dense_n:
            return
        if len(self._dense_log) < n:
            self._dense_log = np.arange(max(n, 2 * len(self._dense_log)),
                                        dtype=np.uint32)
        if self._foreign:
            new = sorted(a for a in self._foreign
                         if self._dense_n <= a < n)
            if new:
                self._dense_coll = sorted(self._dense_coll + new)
                self._dense_coll_arr = np.array(self._dense_coll, np.int64)
        self._dense_n = n

    @_locked
    def dense_addrs(self, n: int) -> np.ndarray:
        """Logical addresses of dense indices 0..n-1: one cached-arange
        slice (the Map.get address vector of a GPV tensor reply)."""
        self._ensure_dense(n)
        return self._dense_log[:n]

    @_locked
    def resolve_dense(self, n: int, qvals: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray,
                                 list[tuple[int, int]]]:
        """Dense index -> address resolution for a GPV tensor segment:
        returns (logical addrs, fixed-point values, collision host-path
        pairs) without touching a per-key Python loop. Element-exact vs
        ``resolve({i: v_i}, p)`` over the same quantized values."""
        self._ensure_dense(n)
        logs = self._dense_log[:n]
        qvals = np.asarray(qvals, np.int64)
        coll = self._dense_coll_arr
        if len(coll) and coll[0] < n:       # collision host path (rare)
            m = coll[coll < n]
            spills = list(zip(m.tolist(), qvals[m].tolist()))
            keep = np.ones(n, bool)
            keep[m] = False
            return logs[keep], qvals[keep], spills
        return logs, qvals, []

    @_locked
    def resolve_dense_f32(self, n: int, fdata: np.ndarray, scale
                          ) -> tuple[np.ndarray, np.ndarray,
                                     list[tuple[int, int]]]:
        """Dense index -> address resolution keeping values as raw fp32
        (the device-resident lane — quantization happens inside the fused
        switch kernel): returns (logical addrs, fp32 values, collision
        host-path pairs). Collision elements quantize on host since they
        ride the spill path. Address routing is identical to
        ``resolve_dense``; only the value dtype differs."""
        self._ensure_dense(n)
        logs = self._dense_log[:n]
        fdata = np.asarray(fdata, np.float32).reshape(-1)
        coll = self._dense_coll_arr
        if len(coll) and coll[0] < n:       # collision host path (rare)
            m = coll[coll < n]
            qcoll = quantize_values(fdata[m], scale)
            spills = list(zip(m.tolist(), qcoll.tolist()))
            keep = np.ones(n, bool)
            keep[m] = False
            return logs[keep], fdata[keep], spills
        return logs, fdata, []

    @_locked
    def resolve(self, kv: dict, precision: int = 0
                ) -> tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]:
        """Key -> logical-address resolution without touching the server:
        returns (logical addrs, fixed-point values, collision host-path
        pairs). The batched pipeline buffers these and flushes many calls'
        worth in one addto_batch. Values quantize in one vectorized pass
        (quantize_stream) when the dict is numerically homogeneous."""
        scale = 10 ** precision
        logs = [self.logical(k) for k in kv]
        vals = quantize_values(list(kv.values()), scale)
        spills = []
        if None in logs:                    # collision host path (rare)
            keep_l, keep_v = [], []
            for k, l, iv in zip(kv, logs, vals.tolist()):
                if l is None:
                    spills.append((hash_key(k), iv))
                else:
                    keep_l.append(l)
                    keep_v.append(iv)
            return (np.array(keep_l, np.uint32),
                    np.array(keep_v, np.int64), spills)
        return (np.array(logs, np.uint32), np.asarray(vals, np.int64),
                spills)

    def addto(self, kv: dict, precision: int = 0) -> None:
        logs, vals, spills = self.resolve(kv, precision)
        self.server.spill_host(spills)
        if len(logs):
            self.server.addto_batch(logs, vals)

    def read(self, key, precision: int = 0) -> float:
        l = hash_key(key)
        return self.server.read(l) / (10 ** precision)

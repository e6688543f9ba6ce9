"""RPCLayer: the gRPC-shaped programming model over the INCLayer (paper §4).

The user-facing front door is the typed declarative schema
(core/schema.py, re-exported via repro_torch/api.py): a ``@inc.service`` class
whose ``@inc.rpc`` methods carry INC semantics as field annotations,
compiled eagerly into the Service/Method/NetFilter objects this module
executes. What lives here is the *data plane* those schemas lower onto —
and the legacy string-keyed surface (``Service``/``Field``/``Stub.call``)
kept as the compatibility shim under the schema layer.

A service is messages with typed fields and methods with request/reply
types — vanilla types replaced by IEDTs (FPArray, IntArray, STRINTMap,
Integer) for the fields the network should process, plus a NetFilter per
method. The stub marshals arguments; IEDT fields travel the INC channel
(the RIP pipeline below), normal fields pass through to the server
handler untouched.

Life of a call (Fig. 5): the client stub pushes the request stream through
Stream.modify -> Map.addTo -> CntFwd gate; if CntFwd drops the packet the
call returns early with only the INC side effects (sub-RTT path); otherwise
the server handler runs and the reply stream executes Map.get (+ the
configured Map.clear policy) on the way back.

Batch API (§5 line-rate plane). There is exactly ONE pipeline
implementation, `_run_pipeline`, which executes a *list* of calls against a
shared channel:

  - ``Stub.call(method, request)``          — the N=1 special case;
  - ``Stub.call_batch(method, requests)``   — N concurrent calls of one
    method, vectorized: one fused Stream.modify per (op, para) group, one
    ``sparse_addto`` batch per register segment for Map.addTo and the
    CntFwd counters, one gather per Map.get;
  - ``NetRPC.submit(stub, method, request)`` / ``NetRPC.drain()`` — a
    micro-batching queue that coalesces calls from *different* stubs and
    methods sharing a channel (the multi-application plane of Fig. 12)
    into one pipeline run per channel;
  - ``Stub.call_async(method, request) -> IncFuture`` — the async front:
    on IncRuntime it returns immediately and the auto-drain scheduler of
    core/runtime.py picks the batch boundaries via size/time/AIMD-window
    triggers, resolving the future off-thread; on plain NetRPC it runs
    inline and returns a resolved future (one futures-first surface);
  - ``Stub.call_batch_async(method, requests) -> list[IncFuture]`` — the
    bulk async front (typed stubs expose it as ``stub.Rpc.batch``): the
    whole list queues in issue order and the same triggers + admission
    backpressure carve it into pipeline batches.

Single-pipeline invariant: the batched execution preserves the sequential
semantics — ``call_batch(reqs) == [call(r) for r in reqs]`` — by buffering
Map.addTo updates in submission order and flushing them (one kernel batch)
before any Map.get observes the map, and by deciding CntFwd gating from the
pre-batch counter values plus the in-batch increment order.  Two documented
deviations, both value-preserving: cache-window boundaries (and hence LRU
eviction instants) may differ because updates arrive in fewer, larger
batches; and handlers must not read INC map state directly (an entry's
addTo may still be buffered when its handler runs) — nested RPC calls are
fine: a nested pipeline pass flushes the enclosing pass's buffer on entry
(``Channel.active_buf``), so it observes everything issued before it.

GPV wire path (array-native tensors). Tensor-shaped request fields (an
ndarray/list where the INC stream's keys are just the flat element
indices) never become per-element Python dicts: ``_stream_items`` wraps
them in a ``TensorSegment`` that carries the raw ndarray, quantization is
one vectorized ``np.rint`` (element-exact vs the scalar
``int(round(x * s))`` oracle), address resolution is a cached arange
lookup in the ClientAgent, Map.addTo/Map.get ride the vectorized
ServerAgent batch paths, and the reply dequantizes in one op. Schema-bound
stubs (core/schema.py) return FPArray/IntArray Map.get replies as
ndarrays shaped like the request; stubs built from a legacy ``Service``
keep the historical ``{index: value}`` dict replies, and map-typed
(STRINTMap) fields are dicts everywhere. ``set_gpv(False)`` (or
``REPRO_GPV=0``) forces the per-element dict path — kept as the semantic
reference.

This module is deliberately framework-level (host-side, numpy); the
register file it drives lives in core/inc_map.py, on the card by default.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.channel import Channel, Controller
from repro_torch.core.clear_policy import POLICIES
from repro_torch.core.inc_map import (hash_key, quantize_stream,
                                      quantize_values)
from repro_torch.core.netfilter import NetFilter
from repro_torch.kernels import ref
from repro_torch.kernels.ops import (device_fold_rounds, fold_rounds,
                                     fold_stream_host)
from repro_torch.obs import hooks as _obs
from repro_torch.obs import trace as _trace

# -- IEDTs -------------------------------------------------------------------

IEDT_TYPES = ("FPArray", "IntArray", "STRINTMap", "Integer")


@dataclass(frozen=True)
class Field:
    name: str
    iedt: str | None = None        # None -> vanilla (pass-through) field

    def __post_init__(self):
        if self.iedt is not None and self.iedt not in IEDT_TYPES:
            raise ValueError(f"unknown IEDT {self.iedt!r}")


@dataclass(frozen=True)
class Method:
    name: str
    request: tuple[Field, ...]
    reply: tuple[Field, ...]
    netfilter: NetFilter


@dataclass
class Service:
    name: str
    methods: dict[str, Method] = field(default_factory=dict)

    def rpc(self, name: str, request: list[Field], reply: list[Field],
            netfilter: NetFilter) -> None:
        self.methods[name] = Method(name, tuple(request), tuple(reply),
                                    netfilter)


# -- server ------------------------------------------------------------------

class Server:
    """Hosts handlers; the INC layer invokes them only for packets that
    pass the CntFwd gate (or when no CntFwd is configured)."""

    def __init__(self):
        self.handlers: dict[str, Callable[[dict], dict]] = {}
        self.calls_seen = 0
        # the host server is shared by every channel; with the sharded
        # plane two channels' pipeline passes invoke handlers
        # concurrently, so the counter increment needs its own lock
        # (handlers themselves run outside it — they may nest RPCs)
        self._seen_lock = threading.Lock()

    def register(self, method: str, fn: Callable[[dict], dict]) -> None:
        self.handlers[method] = fn

    def handle(self, method: str, request: dict) -> dict:
        with self._seen_lock:
            self.calls_seen += 1
        fn = self.handlers.get(method)
        return fn(request) if fn else {}


# -- the batched RIP pipeline ------------------------------------------------

_GPV = [os.environ.get("REPRO_GPV", "1") != "0"]


def gpv_enabled() -> bool:
    return _GPV[0]


def set_gpv(enabled: bool) -> bool:
    """Enable/disable the array-native GPV wire path; returns the previous
    setting. With GPV off every tensor-shaped field is marshalled through
    the per-element dict path — the semantic reference."""
    prev = _GPV[0]
    _GPV[0] = bool(enabled)
    return prev


@dataclass
class TensorSegment:
    """Array-native GPV segment: one tensor-shaped request field carried
    as contiguous ndarrays end-to-end — plan -> Stream.modify -> address
    resolution -> Map.addTo -> Map.get/clear -> dequantize — without ever
    materializing a per-element dict. Elements are addressed by their flat
    index (identity hash, see ClientAgent.resolve_dense); values travel as
    int64 fixed point once ``quantize`` runs."""

    data: np.ndarray                  # raveled request values, input dtype
    shape: tuple[int, ...]            # original field shape (reply shape)
    qvals: np.ndarray | None = None   # int64 fixed-point (phase 1/2)

    def __len__(self) -> int:
        return self.data.shape[0]

    def quantize(self, scale) -> None:
        if self.qvals is None:
            self.qvals = quantize_values(self.data, scale)


def _int32_checked(q: np.ndarray) -> np.ndarray:
    """Narrow quantized modify inputs to int32, raising (like the replaced
    ``np.array(py_ints, np.int32)`` did) instead of silently wrapping a
    value outside the fixed-point register range."""
    if len(q) and (int(q.max()) > 2 ** 31 - 1 or int(q.min()) < -2 ** 31):
        raise OverflowError(
            "quantized Stream.modify values exceed the int32 fixed-point "
            "range; lower the NetFilter precision")
    return q.astype(np.int32)


def _modify(q: np.ndarray, op: str, para: int) -> np.ndarray:
    """Stream.modify of an int32 numpy stream -> int64 numpy."""
    return ref.stream_modify(torch.from_numpy(q), op, para).numpy() \
        .astype(np.int64)


def _stream_items(request: dict, msg_field: str) -> "dict | TensorSegment":
    """``"Message.field"`` -> the items of that request field.

    Fast path (GPV): non-dict values that convert to a numeric ndarray of
    rank >= 1 (ndarrays, lists/tuples of numbers, CPU tensors) become a
    :class:`TensorSegment` and stay arrays through the whole pipeline.
    Dict path: dict values (explicit key -> value maps), scalars, and
    non-numeric payloads are marshalled per element as ``{key: value}``,
    exactly as before the GPV path existed (also forced for everything by
    ``set_gpv(False)``).
    """
    fname = msg_field.split(".")[-1]
    v = request.get(fname)
    if v is None:
        return {}
    if isinstance(v, dict):
        return v
    arr = np.asarray(v)
    if _GPV[0] and arr.ndim >= 1 and arr.dtype.kind in "biuf":
        return TensorSegment(data=arr.reshape(-1), shape=arr.shape)
    return {i: x for i, x in enumerate(arr.ravel())}


@dataclass
class _PlannedCall:
    """One RPC flowing through the (batched) pipeline."""
    agent: Any                                  # ClientAgent of the stub
    md: Method
    request: dict
    array_reply: bool = False                   # ndarray Map.get reply ok
    items: "dict | TensorSegment" = field(default_factory=dict)
    qitems: "dict | TensorSegment" = field(default_factory=dict)
    #         ^ pure-query (ReadMostly/Get-only) key stream: array-shaped
    #           query fields ride the GPV path like addTo streams do
    logs: np.ndarray | None = None              # resolved logical addrs
    vals: np.ndarray | None = None
    device_plan: bool = False                   # device-resident GPV lane ok
    fvals: np.ndarray | None = None             # unquantized fp32 stream
    #         ^ set instead of ``vals`` when the update rides the device
    #           lane: quantization happens inside the fused switch kernel
    spills: list = field(default_factory=list)  # collision host-path pairs
    counter_ops: list = field(default_factory=list)  # CntFwd (key, delta)
    forwarded: bool = True
    completed: bool = False                     # pipeline finished this call
    reply: dict = field(default_factory=dict)
    prefolded: bool = False                     # local_accum flush: items
    #         ^ were quantized+modified+summed per round at fold time
    #           (_FoldBuffer) — phase 1 must not recompute them
    fold_depth: int = 0                         # calls folded into this flush

    @property
    def nf(self) -> NetFilter:
        return self.md.netfilter


class _MapOpBuffer:
    """Ordered, lazily-flushed Map.addTo stream for one channel batch.

    Buffered updates concatenate into ONE ServerAgent.addto_batch per flush
    (one sparse_addto kernel batch per register segment) instead of one
    round trip per call. Collision-routed host-path items ride along and
    are applied at the owning flush so no later Map.get can observe them
    early.
    """

    def __init__(self, server):
        self.server = server
        # ordered stream of ("i", logs, int64 vals) and
        # ("f", logs, fp32 vals, scale) chunks: fp32 chunks come from
        # device-lane calls and flush through the fused quantize+addto
        # kernel; submission order is preserved across both flavors
        self._chunks: list[tuple] = []
        self._extra: list[tuple[int, int]] = []     # scalar (addr, delta)
        self._spills: list[tuple[int, int]] = []

    def addto(self, logs: np.ndarray, vals: np.ndarray) -> None:
        if len(logs):
            self._chunks.append(("i", np.asarray(logs, np.uint32),
                                 np.asarray(vals, np.int64)))

    def addto_f(self, logs: np.ndarray, fvals: np.ndarray, scale) -> None:
        """Buffer an unquantized fp32 update stream (device lane)."""
        if len(logs):
            self._chunks.append(("f", np.asarray(logs, np.uint32),
                                 np.asarray(fvals, np.float32), scale))

    def add_scalar(self, addr: int, delta: int) -> None:
        """Single-register update (CntFwd counters) without the per-call
        array round trip; materialized once at flush."""
        self._extra.append((addr, delta))

    def spill(self, pairs: list[tuple[int, int]]) -> None:
        self._spills.extend(pairs)

    def flush(self) -> None:
        if self._spills:
            # one folded spill/stats update for the whole flush, not a
            # Python loop per collision item
            self.server.spill_host(self._spills)
            self._spills = []
        if self._extra:
            # counter addresses are disjoint from data keys, so appending
            # them after the data chunks preserves observable semantics
            self._chunks.append(("i",
                                 np.array([a for a, _ in self._extra],
                                          np.uint32),
                                 np.array([d for _, d in self._extra],
                                          np.int64)))
            self._extra = []
        if not self._chunks:
            return
        chunks, self._chunks = self._chunks, []
        kinds = {c[0] for c in chunks}
        if kinds == {"f"} and len({c[3] for c in chunks}) == 1:
            # pure device-lane flush at one precision: ONE fused
            # quantize+addto batch, values never quantize on host
            self.server.addto_batch_f32(
                np.concatenate([c[1] for c in chunks]),
                np.concatenate([c[2] for c in chunks]), chunks[0][3])
            return
        if "f" in kinds:
            # mixed flush (or mixed precisions): demote fp32 chunks in
            # submission order via the host quantizer — element-exact for
            # fp32 streams, so the
            # one concatenated int batch preserves ordering semantics
            chunks = [("i", c[1],
                       quantize_stream(c[2], c[3]).astype(np.int64))
                      if c[0] == "f" else c for c in chunks]
        self.server.addto_batch(np.concatenate([c[1] for c in chunks]),
                                np.concatenate([c[2] for c in chunks]))


# How long a pipeline pass may wait for a channel's plane lock before
# concluding the wait is a cross-channel handler cycle (pass on A nested
# into B while a pass on B nested into A) and raising instead of hanging.
# REPRO_PLANE_LOCK_TIMEOUT (seconds) overrides the default; read once at
# import (E1) — tests that need a different value rebind the module
# attribute rather than the environment.
PLANE_LOCK_TIMEOUT = float(os.environ.get("REPRO_PLANE_LOCK_TIMEOUT", "60"))


def _run_pipeline(channel: Channel, host_server: Server,
                  calls: list[_PlannedCall],
                  source: str = "explicit") -> list[dict]:
    """THE data-plane pipeline. Every entry point (call / call_batch /
    drain) lands here; N=1 is just a batch of one.

    Channel-scoped locking: the pass runs under ``channel.plane`` (a
    re-entrant lock), so one channel's pipeline is always serial — the
    sequential/mid-batch-failure semantics are per channel — while
    passes on other channels run concurrently (the sharded plane of
    core/runtime.py). A handler's nested inline call re-enters on its own
    channel and acquires the target's lock on a cross-channel call; a
    cyclic cross-channel handler graph is converted into a RuntimeError
    after ``PLANE_LOCK_TIMEOUT`` instead of a silent deadlock.

    ``source`` attributes the pass to the caller-built ("explicit") or the
    runtime-coalesced ("drained") counters so coalescing efficiency is not
    diluted by interleaved N=1 Stub.call passes on the same channel.
    """
    if not (_obs.METRICS or _obs.TRACE):
        # the zero-overhead default: one module-global bool load + branch,
        # then exactly the pre-obs pass
        if not channel.plane.acquire(timeout=PLANE_LOCK_TIMEOUT):
            raise _plane_lock_timeout(channel)
        try:
            return _run_pipeline_locked(channel, host_server, calls, source)
        finally:
            channel.plane.release()
    return _run_pipeline_observed(channel, host_server, calls, source)


def _plane_lock_timeout(channel: Channel) -> RuntimeError:
    return RuntimeError(
        f"pipeline pass on channel {channel.netfilter.app_name!r} "
        f"could not take the channel plane lock within "
        f"{PLANE_LOCK_TIMEOUT:.0f}s — likely a cyclic cross-channel "
        f"handler call graph (a handler on A calling B while a "
        f"handler on B calls A); break the cycle or use call_async "
        f"for the follow-up")


def _run_pipeline_observed(channel: Channel, host_server: Server,
                           calls: list[_PlannedCall],
                           source: str) -> list[dict]:
    """Instrumented twin of the fast path in ``_run_pipeline``: same lock
    discipline and error semantics, plus plane-lock-wait / pass-duration /
    GPV-coverage metrics and a sampled batch span. If the runtime's drain
    worker already opened a batch span, ``maybe_start`` returns None and
    the phase markers below join the enclosing span's context."""
    app = channel.netfilter.app_name
    ctx = _trace.maybe_start("pipeline", app, n=len(calls),
                             source=source) if _obs.TRACE else None
    t_wait = time.perf_counter()
    acquired = channel.plane.acquire(timeout=PLANE_LOCK_TIMEOUT)
    t0 = time.perf_counter()
    if not acquired:
        _trace.end(ctx)
        raise _plane_lock_timeout(channel)
    try:
        if ctx is not None:
            _trace.phase("plane_lock", t_wait * 1e6)
        gpv_c0 = channel.stats.gpv_calls
        gpv_e0 = channel.stats.gpv_elems
        try:
            return _run_pipeline_locked(channel, host_server, calls, source)
        finally:
            if _obs.METRICS:
                _obs.plane_wait(app, (t0 - t_wait) * 1e6)
                _obs.pipeline_pass(app, len(calls), source, t0)
                dg = channel.stats.gpv_calls - gpv_c0
                _obs.gpv_coverage(app, dg,
                                  channel.stats.gpv_elems - gpv_e0,
                                  len(calls) - dg)
    finally:
        channel.plane.release()
        _trace.end(ctx)


def _run_pipeline_locked(channel: Channel, host_server: Server,
                         calls: list[_PlannedCall],
                         source: str) -> list[dict]:
    server = channel.server
    if channel.active_buf is not None:
        # nested pass (a handler's inline follow-up call on its own
        # channel): the enclosing pass's buffered updates — including
        # deferred reply-path clears — happened-before this call, and
        # re-reading pre-clear state here would double-apply the clear
        channel.active_buf.flush()
    channel.touch()
    channel.stats.calls += len(calls)
    channel.stats.batches += 1
    channel.stats.max_batch = max(channel.stats.max_batch, len(calls))
    if source == "drained":
        channel.stats.drained_calls += len(calls)
        channel.stats.drained_batches += 1
    else:
        channel.stats.explicit_calls += len(calls)
        channel.stats.explicit_batches += 1
    # per-phase spans land on the sampled batch context (if any); ``trc``
    # short-circuits on the module-global bool so the disabled path pays
    # one load + branch here and a falsy local check per phase
    trc = _obs.TRACE and _trace.current() is not None
    t_ph = _trace.now_us() if trc else 0.0

    # ---- phase 1: Stream.modify, fused across the batch --------------------
    for c in calls:
        if c.prefolded:
            # locally folded flush (Agg[...](local_accum=N)): items were
            # quantized, modified and summed per round at fold time —
            # recomputing them from the representative request would drop
            # the folded rounds. The cohort is accounted here, under the
            # plane lock with every other stat (ChannelStats fold audit).
            channel.stats.local_folds += c.fold_depth
            channel.stats.flushes += 1
            if _obs.METRICS:
                _obs.local_fold(channel.netfilter.app_name, c.fold_depth)
            if isinstance(c.items, TensorSegment):
                channel.stats.gpv_calls += 1
                channel.stats.gpv_elems += len(c.items)
            continue
        c.items = (_stream_items(c.request, c.nf.add_to)
                   if c.nf.add_to != "nop" else {})
        if c.nf.add_to == "nop" and c.nf.get != "nop":
            # pure query (ReadMostly / Get-only): the request field carries
            # keys. Array-shaped key streams ride the same GPV path as
            # addTo tensors (dense identity addresses, one vectorized
            # read_batch) instead of a per-element dict.
            c.qitems = _stream_items(c.request, c.nf.get)
            if isinstance(c.qitems, TensorSegment) and not len(c.qitems):
                # a zero-length query array means "no keys named": demote
                # to the dict path so both legs take the same every-
                # spilled-key fallback below (GPV==dict must hold at n=0)
                c.qitems = {}
        seg = (c.items if isinstance(c.items, TensorSegment) else
               c.qitems if isinstance(c.qitems, TensorSegment) else None)
        if seg is not None:
            channel.stats.gpv_calls += 1
            channel.stats.gpv_elems += len(seg)
    groups: dict[tuple[str, int], list[int]] = {}
    for i, c in enumerate(calls):
        if c.items and c.nf.modify.op != "nop" and not c.prefolded:
            groups.setdefault((c.nf.modify.op, c.nf.modify.para), []).append(i)
    for (op, para), ixs in groups.items():
        scaled = []
        for i in ixs:
            c = calls[i]
            s = 10 ** c.nf.precision
            if isinstance(c.items, TensorSegment):
                c.items.quantize(s)
                scaled.append(_int32_checked(c.items.qvals))
            else:
                scaled.append(_int32_checked(
                    quantize_values(list(c.items.values()), s)))
        fused = _modify(np.concatenate(scaled), op, para)
        pos = 0
        for i, seg in zip(ixs, scaled):
            c = calls[i]
            out = fused[pos:pos + len(seg)]
            if isinstance(c.items, TensorSegment):
                # stays fixed point: the dict path's dequantize->requantize
                # round trip is the identity for int32-range values
                c.items.qvals = out
            else:
                s = 10 ** c.nf.precision
                c.items = dict(zip(c.items.keys(), out / s))
            pos += len(seg)
    if trc:
        _trace.phase("stream_modify", t_ph)
        t_ph = _trace.now_us()

    # ---- phase 2: client-side logical-address resolution --------------------
    for c in calls:
        if c.items:
            if isinstance(c.items, TensorSegment):
                if (c.device_plan and c.items.qvals is None
                        and c.items.data.dtype == np.float32):
                    # device lane: the fp32 stream stays unquantized —
                    # the fused switch kernel quantizes on device. Only
                    # fp32 qualifies (the kernel computes in fp32, so a
                    # float64 stream would drift vs the host oracle;
                    # float64 and modify-processed streams host-quantize
                    # below, keeping results element-exact either way).
                    c.logs, c.fvals, c.spills = c.agent.resolve_dense_f32(
                        len(c.items), c.items.data, 10 ** c.nf.precision)
                    continue
                c.items.quantize(10 ** c.nf.precision)
                c.logs, c.vals, c.spills = c.agent.resolve_dense(
                    len(c.items), c.items.qvals)
            else:
                c.logs, c.vals, c.spills = c.agent.resolve(c.items,
                                                           c.nf.precision)
    if trc:
        _trace.phase("resolve_addrs", t_ph)
        t_ph = _trace.now_us()

    # ---- phase 3: CntFwd gating (simulated over pre-batch counters) ---------
    # Counter keys are disjoint from data keys, so the per-tag count at any
    # point in the batch is the pre-batch value plus the in-batch increments
    # before it — no device round trip per call. The actual counter writes
    # are emitted into the ordered update stream (phase 4) so a later batch
    # (or interleaved sequential call) observes the same map state.
    cf_calls = [c for c in calls if c.nf.cnt_fwd.enabled]
    if cf_calls:
        tags = []
        for c in cf_calls:
            ballot = c.request.get(c.nf.cnt_fwd.key.split(".")[-1])
            tag = (next(iter(ballot)) if isinstance(ballot, dict)
                   else c.nf.cnt_fwd.key)
            tags.append(hash_key(f"__cntfwd__{tag}"))
        distinct = sorted(set(tags))
        pre = server.read_batch(np.array(distinct, np.uint32))
        sim = {k: int(v) for k, v in zip(distinct, pre)}
        for c, key in zip(cf_calls, tags):
            sim[key] += 1
            cnt = sim[key]
            # Table 2: forward iff cnt == threshold (exact), so late packets
            # after the quorum are dropped too
            c.forwarded = cnt == c.nf.cnt_fwd.threshold
            c.counter_ops = [(key, 1)]
            if c.forwarded and c.nf.clear != "nop":
                c.counter_ops.append((key, -cnt))
                sim[key] = 0
    if trc:
        _trace.phase("cntfwd_gate", t_ph)
        t_ph = _trace.now_us()

    # ---- phase 4: ordered execution with lazy flushing ----------------------
    # The final flush runs even if a handler raises mid-batch, so calls that
    # already took their turn keep their INC side effects — exactly as if
    # they had been issued sequentially before the failing call.
    buf = _MapOpBuffer(server)
    prev_buf = channel.active_buf          # enclosing pass when nested
    channel.active_buf = buf
    try:
        for c in calls:
            if c.logs is not None:
                buf.spill(c.spills)
                if c.fvals is not None:
                    buf.addto_f(c.logs, c.fvals, 10 ** c.nf.precision)
                else:
                    buf.addto(c.logs, c.vals)
            for key, delta in c.counter_ops:
                buf.add_scalar(key, delta)

            if c.forwarded:
                # normal (non-IEDT) fields pass through to the server handler
                passthrough = {f.name: c.request.get(f.name)
                               for f in c.md.request if f.iedt is None}
                c.reply = dict(host_server.handle(c.md.name,
                                                  passthrough) or {})

            # reply path: Map.get (+ clear policy)
            if c.nf.get != "nop" and c.forwarded:
                buf.flush()      # this get must observe every earlier addTo
                fname = c.nf.get.split(".")[-1]
                scale = 10 ** c.nf.precision
                seg = (c.items if isinstance(c.items, TensorSegment) else
                       c.qitems if isinstance(c.qitems, TensorSegment)
                       else None)
                use_dev = (seg is not None and c.array_reply
                           and c.device_plan
                           and getattr(server, "device", False))
                if use_dev:
                    # device GPV reply: one fused gather+dequantize kernel,
                    # the reply is an fp32 tensor on the switch's device —
                    # the int32 registers never materialize host-side (raw is
                    # pulled back only when a clear must write them back)
                    logs = c.agent.dense_addrs(len(seg))
                    vals_dev, raw = server.read_batch_dev(
                        logs, scale, need_raw=(c.nf.clear in POLICIES))
                    c.reply[fname] = vals_dev.reshape(seg.shape)
                elif seg is not None:
                    # GPV reply: one address-table slice, one gather, one
                    # vectorized dequantize — for the addTo stream's echo
                    # AND for pure-query (ReadMostly/Get) array requests.
                    # Schema-bound stubs take the ndarray (request-shaped);
                    # legacy stubs keep the historical {index: value} dict.
                    logs = c.agent.dense_addrs(len(seg))
                    raw = server.read_batch(logs)
                    vals = raw / scale
                    c.reply[fname] = (vals.reshape(seg.shape)
                                      if c.array_reply else
                                      dict(zip(range(len(seg)),
                                               vals.tolist())))
                else:
                    if c.nf.add_to != "nop":
                        keys = list(c.items.keys())
                    else:
                        # dict reference path for pure queries: qitems is
                        # the request field's {key: _} map ({i: x} for an
                        # array-shaped field with GPV off); an absent
                        # field still falls back to every spilled key
                        keys = list(c.qitems.keys()) or \
                            list(server.spill.keys())
                    logs = np.array([hash_key(k) for k in keys], np.uint32)
                    raw = (server.read_batch(logs) if len(logs)
                           else np.zeros(0, np.int64))
                    c.reply[fname] = {k: int(r) / scale
                                      for k, r in zip(keys, raw)}
                if c.nf.clear in POLICIES:
                    # copy: values are already backed up server-side (the
                    # read above); shadow/lazy semantics are exercised on
                    # the device path (core/clear_policy.py) — here clear
                    # empties the map. The clear rides the ordered update
                    # buffer instead of issuing its own kernel pass: the
                    # next Map.get (or the final flush) applies it together
                    # with any interleaved addTo — one reply-path pass per
                    # flush, not one per cleared call. No earlier observer
                    # exists: handlers must not read INC state, CntFwd
                    # counters live on disjoint keys, every later get
                    # flushes first, and a nested pass (handler inline
                    # call) flushes this buffer on entry via
                    # channel.active_buf.
                    nz = raw != 0
                    if nz.any():
                        buf.addto(logs[nz], -raw[nz])
            c.completed = True
    finally:
        channel.active_buf = prev_buf
        buf.flush()
        if trc:
            _trace.phase("execute", t_ph)
    return [c.reply for c in calls]


# -- client stub -------------------------------------------------------------

def _array_get_field(md: Method) -> bool:
    """True when the method's Map.get target is an array-typed IEDT reply
    field (FPArray/IntArray) — eligible for ndarray-shaped GPV replies."""
    if md.netfilter.get == "nop":
        return False
    fname = md.netfilter.get.split(".")[-1]
    return any(f.name == fname and f.iedt in ("FPArray", "IntArray")
               for f in md.reply)


class Stub:
    """The string-keyed client stub — the compatibility surface under the
    typed schema layer (core/schema.py compiles declarative service
    classes down to this + NetFilter; `make_stub` on a schema class
    returns a generated TypedStub wrapping one of these).

    ``reply_arrays`` stays False here, so a stub built from a legacy
    ``Service`` keeps the historical ``{index: value}`` dict replies even
    for ndarray requests; the schema layer flips it on bind, giving typed
    stubs (and their ``.legacy`` escape hatch) ndarray-shaped
    FPArray/IntArray Map.get replies on the GPV path."""

    def __init__(self, service: Service, channels: dict[str, Channel],
                 server: Server, runtime: "NetRPC"):
        self.service = service
        self.channels = channels          # method -> Channel
        self.server = server
        self.runtime = runtime            # owning NetRPC / IncRuntime
        self.agents = {m: ch.client() for m, ch in channels.items()}
        self.reply_arrays = False
        # methods whose channel is device-resident (schema device=True):
        # their fp32 GPV streams ride the fused quantize/addto device lane
        # and their array replies come back as tensors. Set on bind by
        # the schema layer, like reply_arrays.
        self.device_methods: frozenset = frozenset()
        # methods with Agg[...](local_accum=N>1): the client folds N
        # successive async addTo calls into one switch-bound update
        # (core/schema.py fills this on bind; legacy Services never fold)
        self.accum_methods: dict[str, int] = {}
        self._array_ok = {m: _array_get_field(md)
                          for m, md in service.methods.items()}

    def _plan(self, method: str, request: dict) -> _PlannedCall:
        return _PlannedCall(agent=self.agents[method],
                            md=self.service.methods[method], request=request,
                            array_reply=(self.reply_arrays
                                         and self._array_ok[method]),
                            device_plan=(method in self.device_methods))

    def call(self, method: str, request: dict) -> dict:
        return self.call_batch(method, [request])[0]

    def call_batch(self, method: str, requests: list[dict]) -> list[dict]:
        """Run N concurrent calls of one method through a single pipeline
        pass; replies are positionally aligned with ``requests``."""
        if not requests:
            return []
        return self.runtime.run_direct(self, method, requests)

    def call_async(self, method: str, request: dict) -> "IncFuture":
        """Enqueue one call and return immediately with its IncFuture.
        On an IncRuntime the auto-drain scheduler picks the batch
        boundary (size/time/window triggers); on a plain NetRPC the call
        runs inline and the future comes back already resolved — one
        futures-first surface either way."""
        return self.runtime.call_async(self, method, request)

    def call_batch_async(self, method: str,
                         requests: list[dict]) -> list["IncFuture"]:
        """Bulk submission: one IncFuture per request, resolved through
        the same scheduler triggers as call_async (the whole list lands
        on the channel queue in issue order)."""
        return self.runtime.call_batch_async(self, method, requests)


# -- runtime -----------------------------------------------------------------

def _drain_channel(ch: Channel, host_server: Server) -> int:
    """Execute one channel's queued (ticket, planned call) entries as a
    single pipeline batch; returns the number of tickets resolved. On a
    mid-batch exception, calls that completed keep their effects and their
    tickets resolve (sequential semantics), the rest are abandoned."""
    entries = ch.take_pending()
    if not entries:
        return 0
    n = 0
    try:
        _run_pipeline(ch, host_server, [p for _, p in entries],
                      source="drained")
    finally:
        for t, p in entries:
            if p.completed:
                t.reply = p.reply
                t.done = True
                n += 1
            else:
                t.abandoned = True
    return n


class Ticket:
    """Handle for a submitted-but-not-yet-drained call."""

    __slots__ = ("reply", "done", "abandoned")

    def __init__(self):
        self.reply: dict | None = None
        self.done = False
        self.abandoned = False      # batch died before this call's turn

    def result(self) -> dict:
        if self.abandoned:
            raise RuntimeError(
                "call abandoned: its batch raised before this call "
                "completed; resubmit it")
        if not self.done:
            raise RuntimeError("call not executed yet — drain() the runtime")
        return self.reply


class IncFuture:
    """Completion handle for one async INC call (Stub.call_async).

    Resolved off-thread by the auto-drain scheduler (core/runtime.py).
    ``result()`` blocks until the call's batch drains, re-raising the
    handler exception if its batch failed mid-flight: the failing call gets
    the original exception; calls queued behind it in the same batch get a
    "call abandoned" RuntimeError chained to it (the same sequential error
    semantics as Ticket). Waiting on an unresolved future signals demand to
    the scheduler, so a caller that needs the reply *now* never waits out
    the full time trigger.
    """

    __slots__ = ("_done", "_reply", "_exc", "_wake", "_event", "_callbacks")

    # one lock for ALL futures: the critical sections are a few attribute
    # flips, and futures are created on the submission hot path where even
    # a single allocate_lock per call measurably drags; the Event is
    # created lazily by the first thread that actually blocks.
    _lock = threading.Lock()

    def __init__(self, wake: Callable[[], None] | None = None):
        self._done = False
        self._reply: dict | None = None
        self._exc: BaseException | None = None
        self._wake = wake                # demand-flush hook set by the runtime
        self._event: threading.Event | None = None
        self._callbacks: list[Callable[["IncFuture"], None]] | None = None

    def done(self) -> bool:
        return self._done

    def set_result(self, reply: dict) -> None:
        self._reply = reply
        self._finish()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._finish()

    def _finish(self) -> None:
        with self._lock:
            self._done = True
            ev = self._event
            callbacks, self._callbacks = self._callbacks, None
        if ev is not None:
            ev.set()
        for cb in callbacks or ():
            try:
                cb(self)
            except Exception:    # a callback must not break the resolver
                pass

    def add_done_callback(self, fn: Callable[["IncFuture"], None]) -> None:
        """Run ``fn(future)`` on resolution (immediately if already done).
        Callbacks run on the resolving thread — keep them cheap."""
        with self._lock:
            if not self._done:
                if self._callbacks is None:
                    self._callbacks = []
                self._callbacks.append(fn)
                return
        fn(self)

    def _wait(self, timeout: float | None) -> bool:
        if self._done:
            return True
        if self._wake is not None:
            self._wake()
        with self._lock:
            if self._done:
                return True
            if self._event is None:
                self._event = threading.Event()
            ev = self._event
        return ev.wait(timeout)

    def result(self, timeout: float | None = None) -> dict:
        if not self._wait(timeout):
            raise TimeoutError("INC call did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._reply

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self._wait(timeout):
            raise TimeoutError("INC call did not complete in time")
        return self._exc


def resolve_futures(pairs: list, exc: BaseException | None) -> None:
    """Deliver one pipeline pass's outcome through IncFutures with the
    sequential mid-batch-failure semantics: completed calls resolve; the
    call whose turn raised carries the exception; calls queued behind it
    get a chained "abandoned" error.  If every call completed yet the
    pipeline still raised, the failure came from the trailing buffer
    flush — charge it to the last call (whose flush it would have been in
    a sequential replay) so it cannot vanish.

    ``pairs`` is ``[(IncFuture, _PlannedCall)]`` in issue order.
    """
    all_done = exc is not None and all(p.completed for _, p in pairs)
    failed = False
    for i, (fut, p) in enumerate(pairs):
        if p.completed and not (all_done and i == len(pairs) - 1):
            fut.set_result(p.reply)
        elif not failed:
            failed = True               # the call whose turn raised
            fut.set_exception(exc)
        else:
            err = RuntimeError(
                "call abandoned: its batch raised before this call "
                "completed; resubmit it")
            err.__cause__ = exc
            fut.set_exception(err)


class _FoldBuffer:
    """Client-side local aggregation for ONE channel method
    (``Agg[...](local_accum=N)``): folds successive async addTo calls into
    a single switch-bound update before the pipeline touches the plane.

    Each accepted call is processed exactly as phase 1 would have —
    quantize to the fixed-point integer domain (``rint(x*scale)``), apply
    the configured Stream.modify per round — and the rounds accumulate
    client-side (exact int64 on the host lane; the fused fold kernel on
    the device lane, which saturates as the switch would), so the ONE
    saturating switch addTo at flush is element-exact vs N separate calls
    wherever no intermediate switch sum would have saturated (the same
    fixed-point contract the device lane documents). Pre-quantization
    folding would change rounding; that is why the fold runs
    post-quantize.

    Three lanes, chosen by the first round and sealed on mismatch:

      tensor  dense GPV segments of one shape: per-round int64 quantized
              streams, summed in one fused ``kernels.ops.fold_rounds``.
      dev     fp32 segments on a device channel with no modify: raw fp32
              rounds, quantized+folded in ONE fused fold kernel launch
              on the switch's device (``ops.device_fold_rounds``); the
              fold saturates like N switch addTo hops would.
      dict    sparse maps: keys interned to first-occurrence indices, the
              concatenated (index, qval) rounds merged through the
              existing ``fold_stream_host`` machinery at flush.

    The representative ``_PlannedCall`` carries ``prefolded=True`` so the
    pipeline neither recomputes its items nor re-applies modify; the whole
    cohort's futures resolve with the representative's reply.

    Guarded by ``Channel.fold_lock`` (held by callers around ``fold``);
    never held while taking the plane lock or the runtime work lock.
    """

    def __init__(self, stub: "Stub", method: str):
        self.stub = stub
        self.method = method
        self.md = stub.service.methods[method]
        self.agent = stub.agents[method]
        self.futures: list = []
        self.created: float | None = None   # first-round clock, staleness
        self.mode: str | None = None        # "tensor" | "dev" | "dict"
        self.shape: tuple | None = None
        self.qrounds: list = []             # tensor lane, int64 per round
        self.frounds: list = []             # dev lane, raw fp32 per round
        self.key_ix: dict = {}              # dict lane: key -> intern index
        self.keys: list = []
        self.ix_rounds: list = []
        self.val_rounds: list = []
        self.request: dict | None = None    # first request: passthrough rep

    @property
    def depth(self) -> int:
        return len(self.futures)

    def _round_quantized(self, values, scale) -> np.ndarray:
        """One round's values -> the int64 fixed-point stream phase 1
        would have produced (quantize, then the configured modify)."""
        nf = self.md.netfilter
        q = quantize_values(values, scale)
        if nf.modify.op != "nop":
            q = _modify(_int32_checked(q), nf.modify.op, nf.modify.para)
        return np.asarray(q, np.int64)

    def fold(self, request: dict, fut) -> bool:
        """Fold one call in; False when the request is incompatible with
        the open rounds (lane or shape change) — the caller seals this
        buffer for flushing and retries on a fresh one (which accepts
        any first round)."""
        nf = self.md.netfilter
        scale = 10 ** nf.precision
        items = _stream_items(request, nf.add_to)
        if isinstance(items, TensorSegment):
            if self.mode is None:
                self.mode = ("dev" if (self.method in
                                       self.stub.device_methods
                                       and nf.modify.op == "nop"
                                       and items.data.dtype == np.float32)
                             else "tensor")
                self.shape = items.shape
            elif self.mode == "dict" or items.shape != self.shape:
                return False
            if self.mode == "dev":
                if items.data.dtype != np.float32:
                    return False
                self.frounds.append(items.data)
            else:
                self.qrounds.append(self._round_quantized(items.data, scale))
        else:
            if self.mode is None:
                self.mode = "dict"
            elif self.mode != "dict":
                return False
            if items:
                q = self._round_quantized(list(items.values()), scale)
                ix = np.empty(len(items), np.int64)
                for j, k in enumerate(items):
                    i = self.key_ix.get(k)
                    if i is None:
                        i = self.key_ix[k] = len(self.keys)
                        self.keys.append(k)
                    ix[j] = i
                self.ix_rounds.append(ix)
                self.val_rounds.append(q)
        if self.request is None:
            self.request = request
        self.futures.append(fut)
        return True

    def make_call(self) -> _PlannedCall:
        """Build the sealed buffer's representative pipeline call."""
        nf = self.md.netfilter
        scale = 10 ** nf.precision
        if self.mode == "dev" and self.frounds:
            device = self.stub.runtime.controller.switch.device
            folded = device_fold_rounds(self.frounds, scale, device)
            qsum = folded.cpu().numpy().astype(np.int64)
            items = TensorSegment(data=np.zeros(len(qsum), np.float32),
                                  shape=self.shape, qvals=qsum)
        elif self.mode == "tensor" and self.qrounds:
            qsum = fold_rounds(self.qrounds)
            items = TensorSegment(data=np.zeros(len(qsum), np.float32),
                                  shape=self.shape, qvals=qsum)
        elif self.ix_rounds:
            uniq, _, sums = fold_stream_host(
                np.concatenate(self.ix_rounds),
                np.concatenate(self.val_rounds))
            # resolve() re-quantizes the representative dict: rint((s /
            # scale) * scale) == s exactly for |s| < 2**52 (ints pass
            # through unscaled at scale 1), so the handoff stays exact
            items = {self.keys[int(i)]: (int(s) if scale == 1
                                         else int(s) / scale)
                     for i, s in zip(uniq, sums)}
        else:
            items = {}
        return _PlannedCall(
            agent=self.agent, md=self.md, request=self.request or {},
            array_reply=(self.stub.reply_arrays
                         and self.stub._array_ok[self.method]),
            device_plan=(self.method in self.stub.device_methods),
            items=items, prefolded=True, fold_depth=self.depth)


class _FoldCohort:
    """Future-like fan-out for one folded flush: the representative
    call's resolution is delivered to every folded call's future with the
    mid-batch-failure chaining semantics — on failure the first cohort
    future carries the exception and the rest get a chained "abandoned"
    error, exactly like calls queued behind a failing call today."""

    __slots__ = ("futures",)

    def __init__(self, futures: list):
        self.futures = futures

    def set_result(self, reply: dict) -> None:
        for f in self.futures:
            f.set_result(reply)

    def set_exception(self, exc: BaseException) -> None:
        self.futures[0].set_exception(exc)
        for f in self.futures[1:]:
            err = RuntimeError(
                "call abandoned: its batch raised before this call "
                "completed; resubmit it")
            err.__cause__ = exc
            f.set_exception(err)


class NetRPC:
    """In-process NetRPC runtime: controller + switch + agents.

    make_stub() is the analogue of `NewStub(channel)`; one Channel (GAID,
    switch partition) is created per method's NetFilter AppName, shared by
    all stubs of that app — the multi-application data plane.  Passing a
    schema class (core/schema.py, ``@inc.service``) instead of a legacy
    Service returns the *generated typed stub* with one real method per
    declared RPC and the unified futures-first calling convention.

    submit()/drain() is the micro-batching front: submitted calls queue on
    their channel and drain() executes one pipeline pass per channel, so
    calls from different stubs — and different methods of one app — that
    share a channel coalesce into a single kernel batch.
    """

    def __init__(self, controller: Controller | None = None, device=None):
        self.controller = controller or Controller(device=device)
        self.server = Server()
        self._dirty: list[Channel] = []      # channels with queued calls
        # fold-staleness clock (IncRuntime overrides with its scheduler
        # clock, so virtual-clock tests drive fold aging too)
        self._clock = time.monotonic

    def make_stub(self, service, n_slots: int = 4096):
        schema = getattr(service, "__inc_schema__", None)
        if schema is None and hasattr(service, "bind") \
                and hasattr(service, "channel_policies"):
            schema = service                 # a bare ServiceSchema
        if schema is not None:
            service = schema.service
        channels = {}
        for mname, md in service.methods.items():
            app = md.netfilter.app_name
            want_dev = bool(schema is not None and
                            getattr(schema, "device_apps", {}).get(app))
            if app in self.controller.by_name:
                ch = self.controller.lookup(app)
                if want_dev and not getattr(ch.server, "device", False):
                    raise ValueError(
                        f"channel {app!r} was registered host-resident but "
                        f"this schema declares device=True; register the "
                        f"device schema first (a device channel can serve "
                        f"host schemas, not the reverse)")
            else:
                ch = self.controller.register(md.netfilter, n_slots,
                                              device=want_dev)
            channels[mname] = ch
        if schema is not None:
            for app, pol in schema.channel_policies.items():
                ch = self.controller.lookup(app)
                if ch.drain_policy is not None and ch.drain_policy != pol:
                    raise ValueError(
                        f"channel {app!r} already carries a different "
                        f"DrainPolicy override ({ch.drain_policy}); "
                        f"schemas sharing a channel must agree")
                ch.drain_policy = pol
                # per-channel ServerAgent LRU-window override: huge-tensor
                # channels raise it so a window does not end every call
                # (getattr keeps this module free of a runtime import)
                w = getattr(pol, "window", None)
                if w is not None:
                    if int(w) < 1:
                        raise ValueError(
                            f"channel {app!r}: DrainPolicy.window must be "
                            f">= 1, got {w}")
                    ch.server.window = int(w)
        stub = Stub(service, channels, self.server, runtime=self)
        return schema.bind(stub) if schema is not None else stub

    def run_direct(self, stub: Stub, method: str,
                   requests: list[dict]) -> list[dict]:
        """Synchronous pipeline pass for Stub.call/call_batch. Queued calls
        issued earlier on the channel (via submit()) execute first so issue
        order is preserved."""
        ch = stub.channels[method]
        self._promote_folds(ch)         # folded calls issued earlier first
        if ch.pending:
            _drain_channel(ch, self.server)
        return _run_pipeline(ch, self.server,
                             [stub._plan(method, r) for r in requests])

    def call_async(self, stub: Stub, method: str, request: dict) -> IncFuture:
        """Futures-first surface without a scheduler: the call runs inline
        (one N=1 pipeline pass) and its IncFuture comes back already
        resolved.  IncRuntime overrides this with the auto-drain queue."""
        return self.call_batch_async(stub, method, [request])[0]

    def call_batch_async(self, stub: Stub, method: str,
                         requests: list[dict]) -> list[IncFuture]:
        """Bulk submission on the scheduler-less runtime: one pipeline
        pass over the whole list, futures resolved in place with the
        sequential mid-batch-failure semantics (resolve_futures)."""
        if not requests:
            return []
        if stub.accum_methods.get(method, 0) > 1:
            return self._fold_async(stub, method, requests)
        ch = stub.channels[method]
        self._promote_folds(ch)               # preserve issue order
        if ch.pending:
            _drain_channel(ch, self.server)
        planned = [stub._plan(method, r) for r in requests]
        futs = [IncFuture() for _ in planned]
        exc = None
        try:
            _run_pipeline(ch, self.server, planned)
        except BaseException as e:
            exc = e
        resolve_futures(list(zip(futs, planned)), exc)
        return futs

    # -- client-side local aggregation (Agg[...](local_accum=N)) -------------

    def _fold_async(self, stub: Stub, method: str,
                    requests: list[dict]) -> list[IncFuture]:
        """The fold front for ``local_accum=N`` methods: each async call
        folds into the channel's per-method buffer instead of planning a
        pipeline call; every N-th call seals the buffer and dispatches ONE
        representative switch-bound update whose reply resolves the whole
        cohort. Waiting on a partially-folded future demand-flushes it
        (the wake hook), so no update is ever stranded."""
        ch = stub.channels[method]
        accum = stub.accum_methods[method]
        wake = self._fold_waker(stub, method)
        futs: list[IncFuture] = []
        sealed: list[_FoldBuffer] = []
        with ch.fold_lock:
            for r in requests:
                fb = ch.folds.get(method)
                if fb is None:
                    fb = ch.folds[method] = _FoldBuffer(stub, method)
                    fb.created = self._clock()
                fut = IncFuture(wake=wake)
                if not fb.fold(r, fut):
                    # incompatible with the open rounds (lane or shape
                    # change): seal it and start fresh — a new buffer
                    # accepts any first round
                    sealed.append(ch.folds.pop(method))
                    fb = ch.folds[method] = _FoldBuffer(stub, method)
                    fb.created = self._clock()
                    fb.fold(r, fut)
                futs.append(fut)
                if fb.depth >= accum:
                    sealed.append(ch.folds.pop(method))
            ch.sealing += len(sealed)
        self._dispatch_sealed(ch, sealed)
        return futs

    def _fold_waker(self, stub: Stub, method: str) -> Callable[[], None]:
        """Demand hook installed on folded calls' futures: waiting on a
        partially-folded future flushes its buffer now. (IncRuntime
        overrides this to promote the fold into the scheduler instead.)"""
        ch = stub.channels[method]

        def wake() -> None:
            with ch.fold_lock:
                sealed = [ch.folds.pop(method)] if method in ch.folds else []
                ch.sealing += len(sealed)
            self._dispatch_sealed(ch, sealed)
        return wake

    def _dispatch_sealed(self, ch: Channel, sealed: list) -> None:
        """Dispatch fold buffers popped from ``ch.folds`` (each counted in
        ``ch.sealing`` at its pop, under ``fold_lock``) in seal order, then
        uncount them. Until then the scheduler's issue-order barrier
        (``IncRuntime._promote_folds``) waits: a later call must not pass
        a cohort that another thread has popped but not yet queued."""
        try:
            for fb in sealed:
                self._dispatch_fold(ch, fb)
        finally:
            if sealed:
                with ch.fold_lock:
                    ch.sealing -= len(sealed)
                    ch.sealed.notify_all()

    def _dispatch_fold(self, ch: Channel, fb: _FoldBuffer) -> None:
        """Flush one sealed fold buffer: ONE pipeline pass for the whole
        cohort, futures resolved together; a flush failure chains
        "abandoned" onto the cohort exactly like mid-batch failure.
        (IncRuntime overrides this to enqueue the representative on the
        drain scheduler — one backlog/window slot per flush.)"""
        planned = fb.make_call()
        exc = None
        try:
            _run_pipeline(ch, self.server, [planned])
        except BaseException as e:
            exc = e
        resolve_futures([(_FoldCohort(fb.futures), planned)], exc)

    def _promote_folds(self, ch: Channel) -> None:
        """Seal and dispatch every open fold buffer on the channel: the
        issue-order barrier run before any non-folded pass touches the
        plane, and on drain()/close(flush=True) so no folded update is
        ever stranded."""
        if not ch.folds:
            return
        with ch.fold_lock:
            sealed = [ch.folds.pop(m) for m in list(ch.folds)]
            ch.sealing += len(sealed)
        self._dispatch_sealed(ch, sealed)

    def submit(self, stub: Stub, method: str, request: dict) -> Ticket:
        ch = stub.channels[method]
        t = Ticket()
        if ch not in self._dirty:
            self._dirty.append(ch)
        ch.pending.append((t, stub._plan(method, request)))
        return t

    def drain(self) -> int:
        """Flush every per-channel queue; returns the number of calls run.

        If a handler raises mid-batch, calls that completed before it keep
        their effects and their tickets resolve (sequential semantics); the
        exception then propagates with the rest of that channel's queue
        abandoned — but every OTHER dirty channel stays queued for the
        next drain().
        """
        for ch in list(self.controller.channels.values()):
            self._promote_folds(ch)
        n = 0
        dirty, self._dirty = self._dirty, []
        try:
            while dirty:
                ch = dirty.pop(0)
                n += _drain_channel(ch, self.server)
        finally:
            # channels not reached (an earlier channel's batch raised)
            # stay dirty; drained channels may have been re-dirtied by a
            # handler submitting follow-up calls — keep those too
            self._dirty = dirty + [c for c in self._dirty if c not in dirty]
        return n

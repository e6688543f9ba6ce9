"""repro_torch.obs.trace — span tracing into a bounded ring buffer.

A *batch context* follows one coalesced pipeline batch through the data
plane: the drain worker (or an inline caller) opens it, the pipeline
phases record nested spans on the worker's thread track, and the
channel's synthetic track carries the queue-side story (the "queued"
span from call_async enqueue to drain pick, then the drain itself) — so
a worker-pool drain is visually debuggable per channel AND per worker.

Events live in a fixed-capacity ring (old events are dropped, counted in
``dropped``) and export as Chrome trace-event JSON ("X" complete events
with microsecond ts/dur plus "M" thread-name metadata), loadable in
Perfetto / chrome://tracing as-is.

Sampling is deterministic: every ``stride``-th batch opens a context
(``maybe_start``), the rest record nothing — no RNG on the hot path, and
a traced run is reproducible. The off path is a module-global bool check
at the call site (repro_torch/obs/hooks.py); everything here may assume
tracing is on.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 16384

# synthetic tids for per-channel tracks, far above real thread ids' use
# as *small* ints never collides in practice; the name map disambiguates
_CHANNEL_TRACK_BASE = 1 << 40


def now_us() -> float:
    return time.perf_counter() * 1e6


class TraceRecorder:
    """Bounded ring of trace events + thread/track names."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._names: dict[int, str] = {}      # tid -> track name
        self.dropped = 0                      # evicted by wraparound

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._names.clear()
            self.dropped = 0

    def name_track(self, tid: int, name: str) -> None:
        with self._lock:
            self._names.setdefault(tid, name)

    def add_complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                     tid: int, args: dict | None = None) -> None:
        """Record one "X" (complete) event."""
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append((name, cat, ts_us, dur_us, tid, args))

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event JSON object."""
        pid = os.getpid()
        with self._lock:
            items = list(self._buf)
            names = dict(self._names)
        events = []
        for tid, name in sorted(names.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        for name, cat, ts, dur, tid, args in items:
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": round(ts, 3), "dur": round(max(dur, 0.0), 3),
                  "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "capacity": self.capacity}}

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


TRACER = TraceRecorder()

_tls = threading.local()
_state = {"on": False, "stride": 1}
_batch_seq = itertools.count()          # deterministic sampling counter
_channel_tracks: dict[str, int] = {}
_track_lock = threading.Lock()


def set_tracing(on: bool, stride: int = 1,
                capacity: int | None = None) -> None:
    """Turn span tracing on/off. ``stride`` samples every stride-th batch
    (1 = every batch); ``capacity`` recreates the ring at a new size."""
    global TRACER
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if capacity is not None and capacity != TRACER.capacity:
        TRACER = TraceRecorder(capacity)
    _state["stride"] = int(stride)
    _state["on"] = bool(on)


def enabled() -> bool:
    return _state["on"]


def current():
    """The calling thread's active batch context, or None."""
    return getattr(_tls, "ctx", None)


def channel_track(app: str) -> int:
    """Stable synthetic tid for a channel's timeline track."""
    tid = _channel_tracks.get(app)
    if tid is None:
        with _track_lock:
            tid = _channel_tracks.get(app)
            if tid is None:
                tid = _CHANNEL_TRACK_BASE + len(_channel_tracks)
                _channel_tracks[app] = tid
                TRACER.name_track(tid, f"channel:{app}")
    return tid


class BatchCtx:
    """One sampled batch's trace context (thread-local while active)."""

    __slots__ = ("label", "app", "tid", "t_open", "args")

    def __init__(self, label: str, app: str, args: dict | None):
        self.label = label
        self.app = app
        self.tid = threading.get_ident()
        self.t_open = now_us()
        self.args = args
        TRACER.name_track(self.tid, threading.current_thread().name)


class _PhaseSpan:
    """Context manager for one nested phase on the batch's worker track."""

    __slots__ = ("name", "tid", "args", "t0")

    def __init__(self, name: str, tid: int, args: dict | None):
        self.name = name
        self.tid = tid
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = now_us()
        return self

    def __exit__(self, *exc):
        TRACER.add_complete(self.name, "phase", self.t0,
                            now_us() - self.t0, self.tid, self.args)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def maybe_start(label: str, app: str, **args):
    """Open a batch context if tracing is on, this thread has none, and
    the deterministic sampler picks this batch. Returns the ctx to pass
    to ``end`` (None -> not sampled / already inside a sampled batch)."""
    if not _state["on"] or getattr(_tls, "ctx", None) is not None:
        return None
    if next(_batch_seq) % _state["stride"]:
        return None
    ctx = BatchCtx(label, app, args or None)
    _tls.ctx = ctx
    return ctx


def end(ctx) -> None:
    """Close a context from ``maybe_start`` (None-safe): emits the whole
    batch as one span on the worker track."""
    if ctx is None:
        return
    _tls.ctx = None
    TRACER.add_complete(ctx.label, "batch", ctx.t_open,
                        now_us() - ctx.t_open, ctx.tid, ctx.args)


def phase(name: str, t0_us: float, **args) -> None:
    """Record a completed phase [t0_us, now] on the active batch context
    (no-op without one — unsampled batch)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        TRACER.add_complete(name, "phase", t0_us, now_us() - t0_us,
                            ctx.tid, args or None)


def span(name: str, **args):
    """``with span("..."):`` — records on the active batch context, no-op
    without one."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return NULL_SPAN
    return _PhaseSpan(name, ctx.tid, args or None)


def user_span(name: str, **args):
    """The ``inc.trace(...)`` front door: records on the calling thread's
    track whenever tracing is on (batched or not); no-op when off."""
    if not _state["on"]:
        return NULL_SPAN
    tid = threading.get_ident()
    TRACER.name_track(tid, threading.current_thread().name)
    return _PhaseSpan(name, tid, args or None)


def queued_event(app: str, wait_s: float, n: int, trigger: str) -> None:
    """The queue-side story on the channel track: a "queued" span ending
    now whose duration is the batch's oldest-entry wait, then the drain
    itself is appended by ``drain_event`` when the batch completes."""
    t_now = now_us()
    TRACER.add_complete("queued", "queue", t_now - max(wait_s, 0.0) * 1e6,
                        max(wait_s, 0.0) * 1e6, channel_track(app),
                        {"n": n, "trigger": trigger})


def drain_event(app: str, t0_us: float, n: int, trigger: str) -> None:
    TRACER.add_complete("drain", "queue", t0_us, now_us() - t0_us,
                        channel_track(app), {"n": n, "trigger": trigger})


def validate_chrome_trace(obj) -> None:
    """Raise ValueError unless ``obj`` is a loadable Chrome trace-event
    JSON object (the shape Perfetto's JSON importer accepts)."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace: missing top-level 'traceEvents'")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("trace: 'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"trace event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "M", "B", "E", "i", "C"):
            raise ValueError(f"trace event {i}: bad phase {ph!r}")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                raise ValueError(f"trace event {i}: missing int {k!r}")
        if ph == "X":
            for k in ("name", "ts", "dur"):
                if k not in ev:
                    raise ValueError(f"trace event {i}: missing {k!r}")
            if not isinstance(ev["ts"], (int, float)) \
                    or not isinstance(ev["dur"], (int, float)):
                raise ValueError(f"trace event {i}: ts/dur not numeric")
            if ev["dur"] < 0:
                raise ValueError(f"trace event {i}: negative dur")

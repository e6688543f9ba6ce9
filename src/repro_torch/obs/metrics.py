"""repro_torch.obs.metrics — the low-overhead metrics registry.

Three instrument kinds, Prometheus-shaped:

  Counter    monotonic int (``inc``);
  Gauge      last-write-wins float (``set``);
  Histogram  fixed-bucket distribution (``observe`` / vectorized
             ``observe_many``) with count/sum/min/max and quantile
             estimation interpolated from the cumulative bucket counts.

Design constraints:

  - no-op-when-disabled fast path: every record method checks the owning
    registry's ``enabled`` flag first and returns without taking a lock.
    The data-plane call sites add their own module-global branch on top
    (see repro_torch/obs/hooks.py), so a disabled build pays one global load +
    branch per *batch*, not per metric.
  - lock striping: metrics share a small pool of stripe locks keyed by
    the metric identity hash, so two hot channels recording into
    different metrics almost never contend, while one metric's updates
    stay exact under concurrent writers (pinned by tests/test_obs.py
    with ``workers=4``).
  - histograms are plain objects usable standalone (per-channel
    drain-wait / submit-latency distributions live on the scheduler
    queue, not in the global registry — per-runtime isolation) and
    mergeable across instances with identical bounds.

Exports: ``MetricsRegistry.snapshot()`` (stable dict, schema
``repro.obs/v1``) and ``prometheus_text()`` (text exposition format).
"""
from __future__ import annotations

import threading
from bisect import bisect_left

import numpy as np

SCHEMA_VERSION = "repro.obs/v1"

# default buckets for microsecond latencies: log-ish upper bounds
# (``le`` semantics — a sample lands in the first bucket whose bound is
# >= the value); the +inf bucket is always appended
LATENCY_BUCKETS_US = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1e3, 2e3, 5e3, 1e4, 2e4, 5e4, 1e5, 2e5, 5e5, 1e6, 2e6, 5e6)

# batch-size / element-count buckets (powers of two)
COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                 4096, 16384, 65536, 1 << 20)

_N_STRIPES = 16
_INF = float("inf")


def metric_key(name: str, labels: dict | None) -> str:
    """Canonical identity: ``name{k="v",...}`` with sorted label keys."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc`` is a no-op while the owning registry is
    disabled (handles stay valid across enable/disable flips)."""

    kind = "counter"
    __slots__ = ("name", "labels", "value", "_lock", "_reg")

    def __init__(self, name: str, labels: dict | None = None,
                 lock: threading.Lock | None = None, reg=None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0
        self._lock = lock or threading.Lock()
        self._reg = reg

    def inc(self, n: int = 1) -> None:
        r = self._reg
        if r is not None and not r.enabled:
            return
        with self._lock:
            self.value += n

    def export(self):
        return self.value


class Gauge:
    """Last-write-wins float gauge."""

    kind = "gauge"
    __slots__ = ("name", "labels", "value", "_lock", "_reg")

    def __init__(self, name: str, labels: dict | None = None,
                 lock: threading.Lock | None = None, reg=None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0
        self._lock = lock or threading.Lock()
        self._reg = reg

    def set(self, v: float) -> None:
        r = self._reg
        if r is not None and not r.enabled:
            return
        with self._lock:
            self.value = float(v)

    def export(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with ``le`` (upper-bound) semantics.

    ``bounds`` are strictly increasing finite upper bounds; an +inf
    bucket is appended automatically. Quantiles interpolate linearly
    inside the winning bucket and clamp to the observed min/max, so a
    single-bucket distribution still reports sane p50/p99.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "min", "max", "_lock", "_reg", "_np_bounds")

    def __init__(self, name: str = "histogram", labels: dict | None = None,
                 buckets=LATENCY_BUCKETS_US,
                 lock: threading.Lock | None = None, reg=None):
        b = tuple(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        if any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"bucket bounds must strictly increase: {b}")
        if b[-1] != _INF:
            b = b + (_INF,)
        self.name = name
        self.labels = dict(labels or {})
        self.bounds = b
        self._np_bounds = np.asarray(b, np.float64)
        self.counts = [0] * len(b)
        self.count = 0
        self.sum = 0.0
        self.min = _INF
        self.max = -_INF
        self._lock = lock or threading.Lock()
        self._reg = reg

    def observe(self, v: float) -> None:
        r = self._reg
        if r is not None and not r.enabled:
            return
        v = float(v)
        i = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def observe_many(self, values) -> None:
        """Vectorized observe: one searchsorted + bincount per call, so a
        per-entry latency array from a drained batch costs O(n) numpy,
        not n Python round trips."""
        r = self._reg
        if r is not None and not r.enabled:
            return
        arr = np.asarray(values, np.float64).ravel()
        if arr.size == 0:
            return
        ix = np.searchsorted(self._np_bounds, arr, side="left")
        binc = np.bincount(ix, minlength=len(self.bounds))
        lo = float(arr.min())
        hi = float(arr.max())
        s = float(arr.sum())
        with self._lock:
            for i in np.flatnonzero(binc):
                self.counts[i] += int(binc[i])
            self.count += int(arr.size)
            self.sum += s
            if lo < self.min:
                self.min = lo
            if hi > self.max:
                self.max = hi

    def merge(self, other: "Histogram") -> None:
        """Fold ``other`` into this histogram (identical bounds only)."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bucket bounds: "
                f"{self.bounds} vs {other.bounds}")
        with other._lock:
            counts = list(other.counts)
            count, total = other.count, other.sum
            lo, hi = other.min, other.max
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.count += count
            self.sum += total
            if lo < self.min:
                self.min = lo
            if hi > self.max:
                self.max = hi

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1) from the bucket counts."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self.counts)
            count = self.count
            lo_obs, hi_obs = self.min, self.max
        if count == 0:
            return 0.0
        target = q * count
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c:
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                if hi == _INF:
                    # open-ended bucket: the observed max is the only
                    # finite upper estimate
                    return hi_obs
                frac = (target - (cum - c)) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return min(max(est, lo_obs), hi_obs)
        return hi_obs

    def summary(self) -> dict:
        with self._lock:
            count = self.count
            total = self.sum
            lo, hi = self.min, self.max
        if count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": count, "sum": round(total, 3),
                "min": round(lo, 3), "max": round(hi, 3),
                "mean": round(total / count, 3),
                "p50": round(self.quantile(0.5), 3),
                "p90": round(self.quantile(0.9), 3),
                "p99": round(self.quantile(0.99), 3)}

    def export(self):
        return self.summary()


class MetricsRegistry:
    """Named metrics with get-or-create accessors and stable export.

    Accessors dedupe on (name, sorted labels); re-requesting an existing
    metric with a different kind raises. Collectors registered via
    ``register_collector`` are pulled at snapshot time — the pattern the
    pre-obs counters (ChannelStats, ServerAgent) keep using: they stay
    the single source of truth and the registry reads them on export.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._metrics: dict[str, object] = {}
        self._meta_lock = threading.Lock()
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        self._collectors: list = []   # [(section_name, fn)]

    # -- accessors ---------------------------------------------------------

    def _get(self, cls, name: str, labels: dict, **kw):
        key = metric_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._meta_lock:
                m = self._metrics.get(key)
                if m is None:
                    lock = self._stripes[hash(key) % _N_STRIPES]
                    m = cls(name, labels, lock=lock, reg=self, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {key!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        if buckets is None:
            return self._get(Histogram, name, labels)
        return self._get(Histogram, name, labels, buckets=buckets)

    def register_collector(self, section: str, fn) -> None:
        """``fn() -> dict`` pulled into ``snapshot()["collected"]`` under
        ``section`` (one source of truth: existing counters are read at
        export instead of double-recorded)."""
        with self._meta_lock:
            self._collectors.append((section, fn))

    def reset(self) -> None:
        """Drop every metric and collector (bench legs / test isolation).
        Outstanding handles keep working but no longer export."""
        with self._meta_lock:
            self._metrics = {}
            self._collectors = []

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Stable machine-readable export (schema ``repro.obs/v1``)."""
        with self._meta_lock:
            items = sorted(self._metrics.items())
            collectors = list(self._collectors)
        out = {"schema": SCHEMA_VERSION, "enabled": self.enabled,
               "counters": {}, "gauges": {}, "histograms": {}}
        for key, m in items:
            out[m.kind + "s"][key] = m.export()
        collected = {}
        for section, fn in collectors:
            try:
                collected[section] = fn()
            except Exception as e:        # a broken collector must not
                collected[section] = {"error": repr(e)}   # kill the export
        if collected:
            out["collected"] = collected
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (counters/gauges as-is;
        histograms as cumulative ``_bucket{le=}`` series + _count/_sum)."""
        with self._meta_lock:
            items = sorted(self._metrics.items())
        lines = []
        seen_types = set()
        for key, m in items:
            if m.name not in seen_types:
                seen_types.add(m.name)
                lines.append(f"# TYPE {m.name} {m.kind}")
            if m.kind == "histogram":
                base = dict(m.labels)
                with m._lock:
                    counts = list(m.counts)
                    count, total = m.count, m.sum
                cum = 0
                for bound, c in zip(m.bounds, counts):
                    cum += c
                    le = "+Inf" if bound == _INF else repr(bound)
                    lines.append(
                        metric_key(m.name + "_bucket",
                                   {**base, "le": le}) + f" {cum}")
                lines.append(metric_key(m.name + "_count", base)
                             + f" {count}")
                lines.append(metric_key(m.name + "_sum", base)
                             + f" {total}")
            else:
                lines.append(f"{key} {m.export()}")
        return "\n".join(lines) + "\n"


# the process-wide registry: kernel timings, pipeline counters, and user
# metrics (inc.metrics()) land here; per-runtime latency histograms live
# on the scheduler queues instead (see core/runtime.py)
REGISTRY = MetricsRegistry()

"""repro_torch.obs — end-to-end observability for the INC data plane.

One import gives three things:

  metrics   a lock-striped registry of counters / gauges / fixed-bucket
            histograms with a no-op-when-disabled fast path
            (repro_torch/obs/metrics.py). The data plane records per-channel
            submit→resolve latency, drain-trigger mix, AIMD cw / ECN
            marks, switch hit/miss/spill, GPV coverage, and
            kernel launch timings into it — but ONLY while enabled.
  tracing   span tracing of pipeline batches into a bounded ring buffer,
            exportable as Chrome trace-event JSON (Perfetto-loadable);
            deterministic every-stride-th-batch sampling
            (repro_torch/obs/trace.py).
  export    ``IncRuntime.metrics_snapshot()`` (stable schema
            ``repro.obs/v1``, validated by scripts/obs_schema.json),
            ``registry().prometheus_text()``, and
            ``chrome_trace()``/``write_trace()``.

Everything is OFF by default: the instrumented hot paths compile down to
one module-global bool branch per batch (repro_torch/obs/hooks.py), so the
pre-obs data plane is the disabled mode. Turn it on with::

    from repro_torch import obs
    obs.enable(trace=True, trace_stride=16)
    ... workload ...
    snap = rt.metrics_snapshot()
    obs.write_trace("trace.json")
    obs.disable()

or set ``REPRO_OBS=1`` in the environment (metrics only).
"""
from __future__ import annotations

import os

from repro_torch.obs import hooks as _hooks
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import schema
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, SCHEMA_VERSION)
from repro_torch.obs.trace import TraceRecorder, validate_chrome_trace

__all__ = [
    "SCHEMA_VERSION", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TraceRecorder", "registry", "tracer", "enable", "disable", "enabled",
    "metrics_enabled", "tracing_enabled", "trace_span", "chrome_trace",
    "write_trace", "reset", "validate_chrome_trace", "schema",
]


def registry() -> MetricsRegistry:
    """The process-wide metrics registry (the ``inc.metrics()`` front
    door). Handles obtained while disabled stay valid and start
    recording once ``enable()`` flips the switch."""
    return _metrics.REGISTRY


def tracer() -> TraceRecorder:
    return _trace.TRACER


def enable(metrics: bool = True, trace: bool = False,
           trace_stride: int = 1, trace_capacity: int | None = None
           ) -> None:
    """Turn observability on. ``metrics`` enables the registry;
    ``trace`` enables span tracing, sampling every ``trace_stride``-th
    batch into a ring of ``trace_capacity`` events."""
    _metrics.REGISTRY.enabled = bool(metrics)
    _trace.set_tracing(bool(trace), stride=trace_stride,
                       capacity=trace_capacity)
    _hooks.sync()


def disable() -> None:
    """Back to the zero-overhead default: the data-plane call sites fall
    through their single-bool guards again. Recorded metrics and trace
    events are retained (use ``reset()`` to drop them)."""
    _metrics.REGISTRY.enabled = False
    _trace.set_tracing(False)
    _hooks.sync()


def enabled() -> bool:
    return _hooks.METRICS or _hooks.TRACE


def metrics_enabled() -> bool:
    return _hooks.METRICS


def tracing_enabled() -> bool:
    return _hooks.TRACE


def trace_span(name: str, **args):
    """User-level span (the ``inc.trace(...)`` front door)::

        with inc.trace("train_step", step=i):
            ...

    Records on the calling thread's track while tracing is enabled;
    a no-op context manager otherwise."""
    return _trace.user_span(name, **args)


def chrome_trace() -> dict:
    return _trace.TRACER.chrome_trace()


def write_trace(path) -> None:
    """Dump the trace ring as Chrome trace-event JSON (open the file in
    Perfetto via ui.perfetto.dev > "Open trace file")."""
    _trace.TRACER.write(path)


def reset() -> None:
    """Drop recorded metrics and trace events (bench legs / tests)."""
    _metrics.REGISTRY.reset()
    _trace.TRACER.clear()


if os.environ.get("REPRO_OBS") == "1":
    enable()

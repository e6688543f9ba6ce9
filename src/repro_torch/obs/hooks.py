"""repro_torch.obs.hooks — the switchboard the instrumented hot paths read.

``METRICS`` and ``TRACE`` are plain module globals, flipped only by
``repro_torch.obs.enable()/disable()``. Every data-plane call site guards its
instrumentation with::

    if _obs.METRICS:
        t0 = time.perf_counter()
    ...
    if _obs.METRICS:
        _obs.pipeline_pass(app, n, source, t0)

so the *disabled* build — the default — pays exactly one module-global
load + bool branch per pipeline batch per site: there is no hook object
to call, no registry lookup, no lock. That is the structural entirety of
disabled-mode overhead.

The record functions below run only when obs is enabled; they are
batch-granular (one histogram observe / counter inc per pipeline pass or
kernel launch, never per element).
"""
from __future__ import annotations

import time

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

METRICS = False
TRACE = False

# pipeline-pass durations are typically tens of us to tens of ms;
# element-count instruments use the power-of-two buckets
_US = _metrics.LATENCY_BUCKETS_US
_N = _metrics.COUNT_BUCKETS


def sync() -> None:
    """Mirror the registry/tracer enable state into the call-site bools
    (called by repro_torch.obs.enable/disable)."""
    global METRICS, TRACE
    METRICS = _metrics.REGISTRY.enabled
    TRACE = _trace.enabled()


# -- record functions (enabled mode only) -----------------------------------

def pipeline_pass(app: str, n_calls: int, source: str, t0: float) -> None:
    """One completed pipeline batch on a channel (rpc._run_pipeline)."""
    reg = _metrics.REGISTRY
    dur_us = (time.perf_counter() - t0) * 1e6
    reg.histogram("inc_pipeline_pass_us", buckets=_US, app=app).observe(
        dur_us)
    reg.histogram("inc_pipeline_batch_calls", buckets=_N, app=app).observe(
        n_calls)
    reg.counter("inc_pipeline_calls_total", app=app, source=source).inc(
        n_calls)
    reg.counter("inc_pipeline_batches_total", app=app, source=source).inc()


def plane_wait(app: str, wait_us: float) -> None:
    """Channel plane-lock acquisition wait (contention signal)."""
    _metrics.REGISTRY.histogram("inc_plane_lock_wait_us", buckets=_US,
                                app=app).observe(wait_us)


def gpv_coverage(app: str, gpv_calls: int, gpv_elems: int,
                 dict_calls: int) -> None:
    """GPV vs dict wire-path coverage for one batch."""
    reg = _metrics.REGISTRY
    if gpv_calls:
        reg.counter("inc_gpv_calls_total", app=app).inc(gpv_calls)
        reg.counter("inc_gpv_elems_total", app=app).inc(gpv_elems)
    if dict_calls:
        reg.counter("inc_dict_calls_total", app=app).inc(dict_calls)


def aimd_update(app: str, cw: int, ecn: bool) -> None:
    """Post-drain AIMD ack: cw evolution gauge + ECN mark counter."""
    reg = _metrics.REGISTRY
    reg.gauge("inc_aimd_cw", app=app).set(cw)
    reg.counter("inc_aimd_acks_total", app=app).inc()
    if ecn:
        reg.counter("inc_ecn_marks_total", app=app).inc()


def drain_trigger(app: str, trigger: str) -> None:
    _metrics.REGISTRY.counter("inc_drain_total", app=app,
                              trigger=trigger).inc()


def local_fold(app: str, depth: int) -> None:
    """One local-aggregation flush (Agg[...](local_accum=N)): ``depth``
    calls left the client as ONE switch-bound update, so depth-1 pipeline
    traversals were saved."""
    reg = _metrics.REGISTRY
    reg.counter("inc_local_folds_total", app=app).inc(depth - 1)
    reg.histogram("inc_local_fold_depth", buckets=_N, app=app).observe(depth)


def kernel_launch(kernel: str, n: int, t0: float) -> None:
    """One fused kernel launch (kernels/fused_gpv.py). Host wall time of
    the wrapper: the launch is asynchronous on the card, so this is
    dispatch latency there and execution time of the plain version on
    the CPU."""
    reg = _metrics.REGISTRY
    dur_us = (time.perf_counter() - t0) * 1e6
    reg.histogram("inc_kernel_launch_us", buckets=_US,
                  kernel=kernel).observe(dur_us)
    reg.counter("inc_kernel_elems_total", kernel=kernel).inc(n)


def switch_op(op: str, n: int, t0_us: float) -> None:
    """Switch addto/read span on the active trace context (no-op when the
    batch was not sampled)."""
    _trace.phase(f"switch_{op}", t0_us, n=n)


# -- real-wire transport (repro.net) -----------------------------------------

def wire_retx(flow: int, rto_s: float) -> None:
    """One RTO-driven retransmission on the real wire; ``rto_s`` is the
    backed-off timeout that just fired (the backoff histogram)."""
    reg = _metrics.REGISTRY
    reg.counter("net_retx_total", flow=str(flow)).inc()
    reg.histogram("net_rto_backoff_us", buckets=_US,
                  flow=str(flow)).observe(rto_s * 1e6)


def wire_ack(flow: int, cw: int, ecn: bool) -> None:
    """One real-wire ACK: AIMD cw gauge + ECN mark counter per flow."""
    reg = _metrics.REGISTRY
    reg.gauge("net_aimd_cw", flow=str(flow)).set(cw)
    reg.counter("net_acks_total", flow=str(flow)).inc()
    if ecn:
        reg.counter("net_ecn_marks_total", flow=str(flow)).inc()


def wire_reconnect(flow: int) -> None:
    _metrics.REGISTRY.counter("net_reconnects_total", flow=str(flow)).inc()


def wire_fallback(flow: int) -> None:
    """The channel gave up on the switch and fell back to the host-side
    execution path (graceful degradation)."""
    _metrics.REGISTRY.counter("net_fallback_activations_total",
                              flow=str(flow)).inc()

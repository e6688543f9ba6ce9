"""Async INC runtime: futures, sharded auto-drain workers, weighted-fair
scheduling, and backpressure-coupled micro-batching (paper §3.2, §5).

A single scheduler thread executing every pipeline pass under one global
plane lock would run a multi-application deployment no faster than a
single-application one. That contradicts the paper's central claim: the
INC data plane is *shared*, with many applications using it concurrently
(§3.2, Fig. 12). This module is the sharded version of that plane:

  workers   ``IncRuntime(workers=N)`` runs a pool of N drain workers.
            Channels are the concurrency unit: a pipeline pass runs under
            its channel's own plane lock (``Channel.plane``), so passes
            for *independent* channels execute in parallel — different
            switch-memory segments never contend (per-``Segment`` lock
            striping in core/inc_map.py), and each channel's
            ServerAgent/ClientAgent carry per-instance locks. One
            channel's pipeline stays strictly serial (``busy_owner``
            claim + plane lock), which pins the sequential and
            mid-batch-failure semantics per channel. ``workers=1`` (the
            default) is behaviorally identical to a single scheduler: same
            triggers, same admission control, same future semantics.

  fairness  The ready-queue is serviced with strict-priority tiers and
            deficit-round-robin (DRR) inside a tier. Channels carry a
            ``priority`` class and a ``weight`` (DrainPolicy fields,
            settable per-RPC/service via the schema layer's
            ``@inc.rpc(priority=, weight=)``): a drain-eligible channel in
            a higher tier is always picked first; within a tier every
            ready channel earns ``weight`` credit per pick and the pick
            goes to the largest accumulated deficit, which then pays its
            batch size back — long-run drained calls are proportional to
            weight, and any positive weight guarantees progress (no
            starvation inside a tier). This is the host-side analogue of
            fair scheduling across competing INC flows (P4COM): it keeps
            a shared plane from degrading to head-of-line blocking behind
            one hot channel.

The per-channel drain triggers — each the
in-process analogue of a §5 flow-control mechanism:

  size    the queue reached ``DrainPolicy.max_batch`` calls (line-rate
          coalescing window full).
  time    the oldest queued call aged past ``max_delay`` (bounded-delay
          flush keeping p99 finite at low load).
  window  the AIMD congestion window (core/transport.py) has room for the
          whole queue. The simulated switch ingress queue marks ECN above
          ``ecn_threshold`` like FlipBitSwitch does on the wire; each
          drained batch acks the window, so congestion halves ``cw``.

Backpressure closes the loop: ``call_async`` blocks once a channel's
backlog exceeds ``backlog_factor * cw`` — admission throttles at the
sender. Worker threads and handler (in-pipeline) threads are exempt: they
may hold a channel plane lock another drain needs, so waiting deadlocks.

Completion runs off-thread with the sequential semantics: completed calls keep
their INC side effects and resolve; the failing call's future re-raises
the handler exception; calls queued behind it in the same batch resolve
to a chained "abandoned" error. Synchronous fronts stay available and
ordered per channel; ``drain()`` means *flush everything synchronously*.

``scheduling_report()`` exposes the whole fleet: per-channel coalescing
and GPV counters (audited: drained + explicit == total), plus a
``"__plane__"`` section with per-worker drain/steal counters, per-priority
drain counts and queue-wait percentiles, and the pick-contention count.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from repro_torch.core.channel import Channel
from repro_torch.core.rpc import (IncFuture, NetRPC, Stub, _FoldCohort,
                                  _run_pipeline, resolve_futures)
from repro_torch.core.transport import AimdState, W_MAX_DEFAULT
from repro_torch.obs import hooks as _obs
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import Histogram


@dataclass
class DrainPolicy:
    """Trigger + scheduling knobs for the drain workers (module docstring).

    ``priority``/``weight`` place the channel in the weighted-fair drain
    loop; ``window`` (optional) overrides the channel ServerAgent's LRU
    window length — huge-tensor channels raise it so each call does not
    end a cache window (the per-channel window knob).
    """
    max_batch: int = 64            # size trigger / per-drain take cap
    max_delay: float = 0.002       # time trigger, seconds
    eager_window: bool = True      # window trigger enabled
    backlog_factor: int = 4        # admission bound = backlog_factor * cw
    ecn_threshold: int = 192       # switch occupancy that marks ECN
    service_rate: float = 200_000.0  # simulated switch drain, calls/s
    w_max: int = W_MAX_DEFAULT     # AIMD window cap
    cw_init: int | None = None     # initial window; None -> the batch target
    #                                (AIMD halves it on ECN, so congestion —
    #                                 not slow-start — sets the steady state)
    priority: int = 0              # strict tier: higher drains first
    weight: float = 1.0            # DRR share within the tier (> 0)
    window: int | None = None      # ServerAgent LRU window override

    def initial_cw(self) -> int:
        cw = self.cw_init if self.cw_init is not None else self.max_batch
        return max(1, min(cw, self.w_max))

    def backlog_limit(self, cw: int) -> int:
        return max(self.max_batch, self.backlog_factor * cw)


# deficit accumulation cap, in units of weight-credits: a channel that is
# ready but rarely picked (bursty arrivals) cannot bank unbounded credit
# and then monopolize the tier when it finally gets hot
_DEFICIT_CAP_BATCHES = 4


class _ChannelQueue:
    """Scheduler state for one channel (GAID).  ``policy`` is the
    channel's effective DrainPolicy: a schema-declared per-channel
    override (Channel.drain_policy) when present, else the runtime
    default — every trigger decision for this queue reads it."""

    __slots__ = ("channel", "policy", "entries", "aimd", "occupancy",
                 "busy_owner", "demand", "last_service", "backlog_limit",
                 "wake", "deficit", "last_worker", "drain_waits",
                 "h_wait", "h_lat")

    def __init__(self, channel: Channel, policy: DrainPolicy, now: float):
        if not (policy.weight > 0):      # rejects NaN too, not just <= 0
            raise ValueError(
                f"channel {channel.netfilter.app_name!r}: DrainPolicy."
                f"weight must be > 0, got {policy.weight}")
        self.channel = channel
        self.policy = policy
        self.wake = None                   # demand hook, set by the runtime
        self.entries: deque = deque()      # (IncFuture, _PlannedCall, ts)
        self.aimd = AimdState(cw=policy.initial_cw(), cw_max=policy.w_max)
        self.occupancy = 0.0               # simulated switch ingress queue
        self.busy_owner = None             # thread running a live drain
        self.demand = False                # a waiter needs a flush now
        self.last_service = now
        # cached admission bound, refreshed whenever AIMD moves cw (the
        # submission path checks it per call)
        self.backlog_limit = policy.backlog_limit(self.aimd.cw)
        # weighted-fair drain loop state
        self.deficit = 0.0                 # DRR credit within the tier
        self.last_worker: int | None = None
        self.drain_waits: list = [0, 0.0, 0.0]   # [drains, wait_sum, max]
        # standalone obs histograms (repro_torch.obs), deliberately NOT in the
        # process-wide registry: tests and benches spin up many runtimes
        # reusing app names, and one runtime's p99 must not absorb
        # another's samples. Populated only while obs metrics are enabled;
        # scheduling_report()/metrics_snapshot() surface the quantiles.
        self.h_wait = Histogram("drain_wait_us")      # oldest-entry age
        self.h_lat = Histogram("submit_latency_us")   # submit -> resolve

    def room(self) -> int:
        return max(0, self.aimd.cw - int(self.occupancy))


class IncRuntime(NetRPC):
    """NetRPC with the sharded auto-drain worker pool attached.

    Usage::

        rt = IncRuntime(workers=4)         # or IncRuntime(policy=...)
        stub = rt.make_stub(svc)
        fut = stub.call_async("Push", {...})   # returns immediately
        ...
        reply = fut.result()               # blocks only until its batch drains
        rt.close()                         # or: with IncRuntime() as rt: ...

    ``workers`` drain workers serve every channel; pipeline passes for
    independent channels run in parallel (each under its own channel
    plane lock), while one channel's passes stay strictly serial.
    ``workers=1`` (default) is the single-thread fallback — behaviorally
    identical to a single scheduler thread.
    """

    def __init__(self, controller=None, policy: DrainPolicy | None = None,
                 clock=time.monotonic, workers: int = 1, device=None):
        super().__init__(controller, device=device)
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.policy = policy or DrainPolicy()
        self.workers = int(workers)
        self._clock = clock
        self._queues: dict[int, _ChannelQueue] = {}
        # plain Lock: nothing re-acquires _work while holding it, and the
        # submission path pays for every acquire. Lock order is
        # channel.plane -> _work (a handler inside a pipeline pass may
        # submit follow-up calls); nothing acquires a plane lock while
        # holding _work.
        self._work = threading.Condition(threading.Lock())
        self._tls = threading.local()       # pipeline depth / worker marker
        self._threads: list[threading.Thread] = []
        self._closed = False
        # fleet observability (all guarded by _work)
        self._worker_stats = [{"drains": 0, "calls": 0, "steals": 0}
                              for _ in range(self.workers)]
        self._prio_stats: dict[int, dict] = {}
        self._pick_contention = 0   # picks that went hungry while the only
        #                             drain-eligible channels were busy

    def _in_pipeline(self) -> bool:
        """True when the calling thread is inside a pipeline pass (i.e. a
        server handler). Such a thread holds its channel's plane lock, so
        it must never wait on busy flags or admission — another thread's
        drain could be blocked on a lock it holds (deadlock cycle)."""
        return getattr(self._tls, "depth", 0) > 0

    def _is_worker(self) -> bool:
        return getattr(self._tls, "worker", False)

    def _run_plane(self, fn):
        """Run ``fn`` with the in-pipeline re-entrancy marker set. The
        actual mutual exclusion is channel-scoped now: _run_pipeline
        acquires ``channel.plane`` itself, so this wrapper only maintains
        the per-thread nesting depth the deadlock guards read."""
        self._tls.depth = getattr(self._tls, "depth", 0) + 1
        try:
            return fn()
        finally:
            self._tls.depth -= 1

    # -- async front ---------------------------------------------------------

    def _queue_for(self, ch: Channel) -> _ChannelQueue:
        """Get-or-create scheduler state for a channel (caller holds
        _work).  The channel's schema-declared DrainPolicy override
        (Channel.drain_policy) wins over the runtime default."""
        if self._closed:
            raise RuntimeError("runtime is closed")
        if not self._threads:
            for i in range(self.workers):
                t = threading.Thread(target=self._loop, args=(i,),
                                     name=f"inc-drain-{i}", daemon=True)
                self._threads.append(t)
                t.start()
        q = self._queues.get(ch.gaid)
        if q is None:
            q = self._queues[ch.gaid] = _ChannelQueue(
                ch, ch.drain_policy or self.policy, self._clock())
            gaid = ch.gaid
            q.wake = lambda: self._demand(gaid)
        return q

    def _enqueue(self, q: _ChannelQueue, planned, fut=None) -> IncFuture:
        """Append one planned call to a channel queue (caller holds
        _work), applying admission backpressure: a shrunk congestion
        window bounds the backlog a producer may build before it blocks.
        Workers and handlers (any thread inside a pipeline) are exempt:
        they hold locks a draining thread would need, so waiting
        deadlocks.  ``fut`` lets the fold path enqueue a prefolded
        representative with its _FoldCohort attached: the cohort takes
        ONE backlog slot and one AIMD window slot, however many client
        calls it folded."""
        ch = q.channel
        if (len(q.entries) >= q.backlog_limit
                and not self._is_worker()
                and not self._in_pipeline()):
            ch.stats.admission_waits += 1
            while (len(q.entries) >= q.backlog_limit
                   and not self._closed):
                self._work.wait()
            if self._closed:
                raise RuntimeError("runtime is closed")
        if fut is None:
            fut = IncFuture(wake=q.wake)
        q.entries.append((fut, planned, self._clock()))
        n = len(q.entries)
        ch.stats.note_queue_depth(n)
        # wake the workers only at trigger boundaries — the first
        # entry (arms the time trigger / window check) and the size
        # threshold. Waking them per enqueue would make every submission
        # pay a GIL+lock round trip with the drain pool.
        if n == 1 or n == q.policy.max_batch or q.demand:
            self._work.notify_all()
        return fut

    def call_async(self, stub: Stub, method: str, request: dict) -> IncFuture:
        if stub.accum_methods.get(method, 0) > 1:
            return self._fold_async(stub, method, [request])[0]
        ch = stub.channels[method]
        if ch.folds or ch.sealing:
            self._promote_folds(ch)     # issue order across methods
        planned = stub._plan(method, request)
        with self._work:
            q = self._queue_for(ch)
            return self._enqueue(q, planned)

    def call_batch_async(self, stub: Stub, method: str,
                         requests: list[dict]) -> list[IncFuture]:
        """Bulk submission through the scheduler (the bulk
        ``call_batch_async`` front): the whole list lands on the channel
        queue in issue order under one lock round trip, and the same
        size/time/window triggers decide the pipeline batch boundaries.
        Admission backpressure applies per call: once the backlog limit
        is hit, the submitter blocks mid-list until a worker drains
        room, so a huge batch cannot bypass the congestion coupling."""
        if not requests:
            return []
        if stub.accum_methods.get(method, 0) > 1:
            return self._fold_async(stub, method, requests)
        ch = stub.channels[method]
        if ch.folds or ch.sealing:
            self._promote_folds(ch)     # issue order across methods
        planned = [stub._plan(method, r) for r in requests]
        if not planned:
            return []
        with self._work:
            q = self._queue_for(ch)
            return [self._enqueue(q, p) for p in planned]

    def submit(self, stub: Stub, method: str, request: dict) -> IncFuture:
        """On the async runtime submit() IS call_async: the returned
        IncFuture resolves when a trigger drains the channel — no explicit
        drain() needed (result() blocks until then)."""
        return self.call_async(stub, method, request)

    # -- local aggregation on the scheduler ----------------------------------

    def _fold_async(self, stub: Stub, method: str,
                    requests: list[dict]) -> list[IncFuture]:
        """Folding front on the scheduler: calls fold exactly as on base
        NetRPC, but a buffer left partially full registers the channel's
        queue and pokes the workers, so the time trigger (max_delay
        staleness, _promote_due_folds) flushes it — a partial fold never
        waits for its N-th call."""
        futs = super()._fold_async(stub, method, requests)
        ch = stub.channels[method]
        if ch.folds:
            with self._work:
                self._queue_for(ch)
                self._work.notify_all()
        return futs

    def _fold_waker(self, stub: Stub, method: str):
        """result() on a folded call's future: flush its buffer through
        the scheduler now (promote + demand), instead of dispatching
        inline like base NetRPC."""
        ch = stub.channels[method]

        def wake() -> None:
            if self._is_worker() or self._in_pipeline():
                raise RuntimeError(
                    "IncFuture.result() inside a server handler would "
                    "deadlock the data plane; handlers must not wait on "
                    "futures")
            self._promote_folds(ch)
            self._demand(ch.gaid)
        return wake

    def _dispatch_fold(self, ch: Channel, fb) -> None:
        """Sealed fold buffers become ONE representative entry on the
        channel's drain queue: one backlog slot, one AIMD window slot,
        one pipeline call — the folded cohort's futures ride along as a
        _FoldCohort and resolve together when the representative drains.
        A nested dispatch (handler thread inside a pipeline pass) runs
        inline like base NetRPC — the channel plane is re-entrant and
        the worker serving it must not wait on itself."""
        if self._in_pipeline():
            return super()._dispatch_fold(ch, fb)
        planned = fb.make_call()
        cohort = _FoldCohort(fb.futures)
        try:
            with self._work:
                q = self._queue_for(ch)
                self._enqueue(q, planned, fut=cohort)
        except BaseException as e:
            # a closed runtime (or an admission wait cut short by close)
            # must still resolve the cohort — the fold buffer is already
            # popped, so nothing else will
            cohort.set_exception(e)

    def _promote_due_folds(self) -> None:
        """Worker-side staleness sweep: seal and enqueue any fold buffer
        older than its channel's max_delay — the fold analogue of the
        time trigger, so a partial fold's latency is bounded exactly
        like a queued call's."""
        with self._work:
            queues = list(self._queues.values())
        now = self._clock()
        for q in queues:
            ch = q.channel
            if not ch.folds:
                continue
            ripe = []
            with ch.fold_lock:
                for m in list(ch.folds):
                    fb = ch.folds[m]
                    if (fb.created is not None
                            and now - fb.created >= q.policy.max_delay):
                        ripe.append(ch.folds.pop(m))
                ch.sealing += len(ripe)
            self._dispatch_sealed(ch, ripe)

    def _promote_folds(self, ch: Channel) -> None:
        """The issue-order barrier: seal and queue this channel's open
        fold buffers, then wait until no buffer another thread has popped
        (a full one, or a stale one the sweep sealed) is still on its way
        to the queue, so a call issued after this one cannot pass it. A
        drain worker or a handler does not wait: the popping thread may
        be waiting for it to drain room."""
        super()._promote_folds(ch)
        if self._is_worker() or self._in_pipeline():
            return
        with ch.fold_lock:
            while ch.sealing:
                ch.sealed.wait()

    # -- synchronous fronts (ordering-preserving) ----------------------------

    def run_direct(self, stub: Stub, method: str,
                   requests: list[dict]) -> list[dict]:
        if self._is_worker() or self._in_pipeline():
            # nested inline call from a server handler (a drain worker, or
            # any thread already inside a pipeline pass): never wait on
            # busy flags — this thread may own one, and even on another
            # channel the flag's owner could be blocked on a plane lock
            # this thread holds (deadlock cycle) — run the pass directly;
            # the channel plane locks are re-entrant
            return self._run_plane(
                lambda: super(IncRuntime, self).run_direct(stub, method,
                                                           requests))
        ch = stub.channels[method]
        if ch.folds or ch.sealing:
            # folded calls issued earlier join the queue first and run
            # in the "inline" backlog pass below (issue order)
            self._promote_folds(ch)
        me = threading.current_thread()
        with self._work:
            q = self._queues.get(ch.gaid)
            if q is not None:
                while q.busy_owner is not None:
                    self._work.wait()
                q.busy_owner = me
                backlog = list(q.entries)
                q.entries.clear()
                ch.stats.note_queue_depth(0)
        if q is None:
            return self._run_plane(
                lambda: super(IncRuntime, self).run_direct(stub, method,
                                                           requests))
        try:
            if backlog:
                # async calls issued before this inline call run first
                exc = self._execute(q, backlog, "inline")
                if exc is not None:
                    raise exc
            return self._run_plane(
                lambda: super(IncRuntime, self).run_direct(stub, method,
                                                           requests))
        finally:
            with self._work:
                q.busy_owner = None
                if not q.entries:
                    q.demand = False
                    q.deficit = 0.0    # classic DRR: credit/debt is only
                    #                    meaningful while backlogged
                self._work.notify_all()

    def drain(self) -> int:
        """Flush every channel queue synchronously; returns calls resolved.

        Unlike NetRPC.drain, exceptions are delivered through the affected
        IncFutures first; the first one is re-raised after every channel
        has been flushed.
        """
        if self._is_worker() or self._in_pipeline():
            # same cycle either way: an inline pass marks its channel busy
            # before running handlers, so a handler's drain() would wait
            # forever on a busy flag owned by its own (blocked) thread
            raise RuntimeError(
                "drain() inside a server handler would deadlock the drain "
                "worker; handlers may only call_async follow-up work")
        for ch in list(self.controller.channels.values()):
            self._promote_folds(ch)
        n = 0
        first_exc = None
        with self._work:
            queues = list(self._queues.values())
        for q in queues:
            with self._work:
                while q.busy_owner is not None:
                    self._work.wait()
                if not q.entries:
                    continue
                q.busy_owner = threading.current_thread()
                backlog = list(q.entries)
                q.entries.clear()
                q.channel.stats.note_queue_depth(0)
            try:
                exc = self._execute(q, backlog, "flush")
            finally:
                with self._work:
                    q.busy_owner = None
                    q.demand = False
                    if not q.entries:
                        q.deficit = 0.0
                    self._work.notify_all()
            n += sum(1 for _, p, _ in backlog if p.completed)
            first_exc = first_exc or exc
        # base-class ch.pending queues (legacy submit tickets): the plain
        # delegation still works because each channel's pipeline pass
        # takes its own plane lock inside _run_pipeline; _run_plane only
        # marks the thread in-pipeline for the nested-handler guards
        n += self._run_plane(super().drain)
        if first_exc is not None:
            raise first_exc
        return n

    # -- lifecycle -----------------------------------------------------------

    def close(self, flush: bool = True) -> None:
        """Stop the worker pool; by default flush outstanding work first.
        Queued-but-unflushed futures (flush=False) resolve to an error.
        Idempotent: closing an already-closed runtime is a no-op."""
        if flush and not self._closed:
            try:
                self.drain()
            except BaseException:
                # the flush's call outcomes (including this exception) are
                # already delivered through the affected IncFutures; the
                # shutdown itself must still complete
                pass
        with self._work:
            self._closed = True
            leftovers = [e for q in self._queues.values() for e in q.entries]
            for q in self._queues.values():
                q.entries.clear()
            self._work.notify_all()
        for fut, _, _ in leftovers:
            fut.set_exception(RuntimeError("runtime closed before drain"))
        # folded-but-never-flushed calls (flush=False, or folds accepted
        # after the drain): their buffers die with the runtime, so their
        # futures get the same terminal error as queued leftovers
        stranded = []
        for ch in list(self.controller.channels.values()):
            with ch.fold_lock:
                for fb in ch.folds.values():
                    stranded.extend(fb.futures)
                ch.folds.clear()
        for fut in stranded:
            fut.set_exception(RuntimeError("runtime closed before drain"))
        threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "IncRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc[0] is None)

    # -- observability -------------------------------------------------------

    def scheduling_report(self) -> dict:
        """Scheduling behavior of the multi-tenant plane.

        One entry per application (keyed by AppName) with that channel's
        coalescing/queue/GPV counters plus its scheduling class
        (priority, weight, DRR deficit, drain-wait stats), and a reserved
        ``"__plane__"`` entry aggregating the worker pool: per-worker
        drain/call/steal counters, per-priority drain counts and wait
        times, and the pick-contention count.

        Also audits the stats split: every pipeline pass is attributed to
        exactly one source, so ``drained + explicit == total`` must hold
        for calls and batches — a double-count (or a new entry point that
        forgot its attribution) raises here rather than silently skewing
        the coalescing-efficiency numbers this report exists to expose.
        Each channel is audited under its own plane lock (taken before
        _work — the established order): the per-pass counters mutate
        under it mid-pipeline, so auditing without it could observe a
        half-updated split and raise spuriously.
        """
        out = {}
        with self._work:
            queues = list(self._queues.items())
        for gaid, q in queues:
            with q.channel.plane:
                with self._work:
                    out[q.channel.netfilter.app_name] = \
                        self._channel_entry(gaid, q)
        with self._work:
            out["__plane__"] = {
                "workers": {f"w{i}": dict(s)
                            for i, s in enumerate(self._worker_stats)},
                "priorities": {
                    p: {"drains": s["drains"], "calls": s["calls"],
                        "mean_wait_us": round(
                            s["wait_sum"] / s["drains"] * 1e6, 1)
                        if s["drains"] else 0.0,
                        "max_wait_us": round(s["wait_max"] * 1e6, 1)}
                    for p, s in sorted(self._prio_stats.items())},
                "pick_contention": self._pick_contention,
            }
        out["__switch__"] = self._switch_report()
        # real-wire deployments (Controller(switch=RemoteSwitchMemory(...)))
        # carry the transport's failure story — reconnects, retx, AIMD cw,
        # and whether the channel degraded to the host-side fallback plane.
        # Duck-typed so repro_torch.core never imports a wire client.
        sw = self.controller.switch
        if hasattr(sw, "fallback_active") and hasattr(sw, "report"):
            out["__wire__"] = sw.report()
        return out

    def _channel_entry(self, gaid: int, q: _ChannelQueue) -> dict:
        """One channel's report entry. Caller holds the channel's plane
        lock and _work (in that order). Shared by scheduling_report()
        and metrics_snapshot() so the two exports cannot drift."""
        st = q.channel.stats
        st.check_consistent()
        drains, wait_sum, wait_max = q.drain_waits
        entry = {
            "gaid": gaid,
            "queue_depth": len(q.entries),
            "max_queue_depth": st.max_queue_depth,
            "cw": q.aimd.cw,
            "occupancy": round(q.occupancy, 1),
            "drains": dict(st.drain_triggers),
            "calls": st.calls,
            "explicit_calls": st.explicit_calls,
            "drained_calls": st.drained_calls,
            "drained_batches": st.drained_batches,
            "mean_drained_batch": round(st.mean_drained_batch, 2),
            "admission_waits": st.admission_waits,
            "gpv_calls": st.gpv_calls,
            "gpv_elems": st.gpv_elems,
            "priority": q.policy.priority,
            "weight": q.policy.weight,
            "deficit": round(q.deficit, 2),
            "mean_drain_wait_us": round(
                wait_sum / drains * 1e6, 1) if drains else 0.0,
            "max_drain_wait_us": round(wait_max * 1e6, 1),
            "acks": q.aimd.acks,
            "ecn_marks": q.aimd.ecn_marks,
            # local aggregation (Agg[...](local_accum=N)): effective calls
            # per wire call — every flush carried (1 + its folds) client
            # calls as ONE pipeline call, so reduction >= 1.0 always
            "local_folds": st.local_folds,
            "flushes": st.flushes,
            "traffic_reduction": round(
                (st.calls - st.flushes + st.local_folds) / st.calls, 3)
            if st.calls else 1.0,
        }
        # obs histograms (populated only while metrics are enabled): the
        # per-channel latency story the mean/max pair above cannot tell
        if q.h_wait.count:
            entry["drain_wait_p50_us"] = round(q.h_wait.quantile(0.5), 1)
            entry["drain_wait_p99_us"] = round(q.h_wait.quantile(0.99), 1)
        if q.h_lat.count:
            entry["latency_p50_us"] = round(q.h_lat.quantile(0.5), 1)
            entry["latency_p99_us"] = round(q.h_lat.quantile(0.99), 1)
        return entry

    def _switch_report(self) -> dict:
        """The shared switch's story (the ``"__switch__"`` report
        section): per-app server-agent cache behavior (hits/misses/CHR,
        spill size, partition) plus switch-wide slot occupancy per
        Segment. Reads live counters without locks — the numbers are a
        monitoring snapshot, not a consistency audit."""
        sw = self.controller.switch
        apps = {}
        with self._work:
            queues = list(self._queues.values())
        known = {q.channel.gaid for q in queues}
        channels = list(self.controller.channels.values())
        for ch in channels:
            srv = ch.server
            apps[ch.netfilter.app_name] = {
                "gaid": ch.gaid,
                "hits": srv.hits,
                "misses": srv.misses,
                "cache_hit_ratio": round(srv.cache_hit_ratio, 4),
                "spill_keys": len(srv.spill),
                "capacity": srv.capacity,
                "inc_bytes": ch.stats.inc_bytes,
                "host_bytes": ch.stats.host_bytes,
                "scheduled": ch.gaid in known,
            }
        return {
            "apps": apps,
            "total_slots": sw.total_slots,
            "allocated_slots": sum(n for _, n in sw.partitions.values()),
            "segments": sw.occupancy(),
        }

    def metrics_snapshot(self) -> dict:
        """The exportable obs snapshot (schema ``repro.obs/v1``,
        validated in CI against scripts/obs_schema.json): the per-channel
        scheduling entries (with drain-wait / submit-latency quantiles
        when obs metrics were enabled), the plane and switch sections,
        and the process-wide metrics registry."""
        rep = self.scheduling_report()
        plane = rep.pop("__plane__")
        switch = rep.pop("__switch__")
        wire = rep.pop("__wire__", None)
        snap = {
            "schema": _metrics.SCHEMA_VERSION,
            "enabled": _obs.METRICS,
            "channels": rep,
            "plane": plane,
            "switch": switch,
            "metrics": _metrics.REGISTRY.snapshot(),
        }
        if wire is not None:
            snap["wire"] = wire
        return snap

    # -- scheduler internals -------------------------------------------------

    def _demand(self, gaid: int) -> None:
        """IncFuture.result() on an unresolved future: flush its channel
        now instead of waiting out the time trigger."""
        if self._is_worker() or self._in_pipeline():
            raise RuntimeError(
                "IncFuture.result() inside a server handler would deadlock "
                "the data plane; handlers must not wait on futures")
        with self._work:
            q = self._queues.get(gaid)
            if q is not None and q.entries:
                q.demand = True
                self._work.notify_all()

    def _service(self, q: _ChannelQueue, now: float) -> None:
        """Decay the simulated switch ingress queue (continuous service)."""
        dt = max(0.0, now - q.last_service)
        q.last_service = now
        q.occupancy = max(0.0, q.occupancy - dt * q.policy.service_rate)

    def _due(self, q: _ChannelQueue, now: float, ignore_busy: bool = False):
        """(trigger, take) if this queue should drain now, else None.
        ``ignore_busy`` evaluates due-ness for an already-claimed queue —
        only the contention accounting in _pick uses it."""
        n = len(q.entries)
        if n == 0 or (q.busy_owner is not None and not ignore_busy):
            return None
        room = q.room()
        take = min(n, q.policy.max_batch, room)
        if take > 0:
            if n >= q.policy.max_batch:
                return ("size", take)
            if q.demand:
                return ("flush", take)
            if now - q.entries[0][2] >= q.policy.max_delay:
                return ("time", take)
        if q.policy.eager_window and n <= room:
            return ("window", n)
        return None

    def _pick(self, now: float):
        """Weighted-fair choice among drain-eligible channels (caller
        holds _work): strict-priority tiers, deficit-round-robin within
        the winning tier. Returns (queue, trigger, take) or None; adjusts
        the DRR deficits (the pick pays its take immediately — the caller
        must claim and execute the batch it was handed)."""
        due = []
        busy_due = False
        for q in self._queues.values():
            if not q.entries:
                continue
            self._service(q, now)
            if q.busy_owner is not None:
                # claimed by another worker; due-ness (ignoring the
                # claim) feeds the contention signal below
                busy_due = busy_due or \
                    self._due(q, now, ignore_busy=True) is not None
                continue
            hit = self._due(q, now)
            if hit is not None:
                due.append((q, hit))
        if not due:
            if busy_due:
                # every channel with drainable work is claimed by another
                # worker: this picker goes hungry (the contention signal
                # that says more channels — not more workers — is the
                # scaling lever)
                self._pick_contention += 1
            return None
        top = max(q.policy.priority for q, _ in due)
        tier = [(q, hit) for q, hit in due if q.policy.priority == top]
        # DRR: every ready channel in the serviced tier earns its weight;
        # the largest deficit wins (FIFO on ties) and pays its take, so
        # long-run drained calls are proportional to weight. Deficits are
        # clamped symmetrically: the cap stops a rarely-picked channel
        # banking unbounded credit, the floor stops a channel that drained
        # alone (paying take with nobody to share with) banking unbounded
        # DEBT it would pay off by starving once a sibling joins the tier
        for q, _ in tier:
            cap = _DEFICIT_CAP_BATCHES * q.policy.max_batch * q.policy.weight
            q.deficit = min(q.deficit + q.policy.weight, cap)
        q, (trigger, take) = max(
            tier, key=lambda qh: (qh[0].deficit, -qh[0].entries[0][2]))
        cap = _DEFICIT_CAP_BATCHES * q.policy.max_batch * q.policy.weight
        q.deficit = max(q.deficit - take, -cap)
        return q, trigger, take

    def _next_wake(self, now: float) -> float | None:
        """Seconds until the earliest time trigger or window-room event."""
        best = None
        for q in self._queues.values():
            if not q.entries or q.busy_owner is not None:
                continue
            cand = q.entries[0][2] + q.policy.max_delay - now
            if q.room() == 0:
                # no drain can happen before the simulated switch services
                # one packet of window room, however overdue the time
                # trigger is — sleeping shorter would busy-poll the scan
                decay = (q.occupancy - q.aimd.cw + 1) \
                    / q.policy.service_rate
                cand = max(cand, decay)
            best = cand if best is None else min(best, cand)
        # partial fold buffers age toward their staleness flush on the
        # same max_delay clock (lock order _work -> fold_lock; no fold
        # path takes _work while holding fold_lock)
        for q in self._queues.values():
            ch = q.channel
            if not ch.folds:
                continue
            with ch.fold_lock:
                for fb in ch.folds.values():
                    if fb.created is None:
                        continue
                    cand = fb.created + q.policy.max_delay - now
                    best = cand if best is None else min(best, cand)
        if best is None:
            return None
        return max(best, 1e-4)

    def _loop(self, wid: int) -> None:
        self._tls.worker = True
        stats = self._worker_stats[wid]
        while True:
            # the fold staleness sweep runs outside _work (its dispatches
            # re-enter _work to enqueue representatives); every wakeup
            # re-checks, so a ripe partial fold becomes a queue entry and
            # the ordinary triggers below drain it
            self._promote_due_folds()
            with self._work:
                if self._closed:
                    return
                now = self._clock()
                due = self._pick(now)
                if due is None:
                    self._work.wait(self._next_wake(now))
                    continue
                q, trigger, take = due
                batch = [q.entries.popleft() for _ in range(take)]
                q.busy_owner = threading.current_thread()
                if q.last_worker is not None and q.last_worker != wid:
                    stats["steals"] += 1
                q.last_worker = wid
                stats["drains"] += 1
                stats["calls"] += len(batch)
                # queue-wait accounting (per channel and per priority
                # tier): age of the batch's oldest entry at pick time
                wait = max(0.0, now - batch[0][2])
                q.drain_waits[0] += 1
                q.drain_waits[1] += wait
                q.drain_waits[2] = max(q.drain_waits[2], wait)
                ps = self._prio_stats.setdefault(
                    q.policy.priority,
                    {"drains": 0, "calls": 0, "wait_sum": 0.0,
                     "wait_max": 0.0})
                ps["drains"] += 1
                ps["calls"] += len(batch)
                ps["wait_sum"] += wait
                ps["wait_max"] = max(ps["wait_max"], wait)
                q.channel.stats.note_queue_depth(len(q.entries))
            try:
                self._execute(q, batch, trigger)
            except BaseException:
                # futures carry the call outcome; nothing here may kill a
                # drain worker (producers block on the pool for admission)
                pass
            finally:
                with self._work:
                    q.busy_owner = None
                    if not q.entries:
                        q.demand = False
                        q.deficit = 0.0
                    self._work.notify_all()

    def _execute(self, q: _ChannelQueue, entries, trigger: str):
        """One pipeline pass for ``entries``; resolves futures; returns the
        pipeline exception (already delivered to futures) or None. Runs
        under the channel's plane lock (acquired inside _run_pipeline), so
        passes for other channels proceed concurrently."""
        ch = q.channel
        exc = None
        t_start = self._clock()
        ctx = None
        t_drain_us = 0.0
        if _obs.TRACE:
            app = ch.netfilter.app_name
            ctx = _trace.maybe_start("drain", app, n=len(entries),
                                     trigger=trigger)
            if ctx is not None:
                # the queue-side story on the channel's synthetic track:
                # a "queued" span ending now, then the drain span below
                _trace.queued_event(app, t_start - entries[0][2],
                                    len(entries), trigger)
                t_drain_us = _trace.now_us()
        try:
            self._run_plane(lambda: _run_pipeline(
                ch, self.server, [p for _, p, _ in entries],
                source="drained"))
        except BaseException as e:          # delivered via futures below
            exc = e
        with self._work:
            # the batch entered the switch when the drain started and was
            # serviced *during* it — credit arrivals before decaying over
            # the drain interval, so ECN reflects sustained overload (load
            # beyond service_rate), not the burst shape of one batch
            self._service(q, t_start)
            q.occupancy += len(entries)
            self._service(q, self._clock())
            # one ACK per batch; ECN set iff the simulated ingress queue is
            # above threshold (persisted implicitly: occupancy only decays
            # through service, as the transport persists ECN in the map).
            # AIMD state is per channel and only ever touched under _work,
            # so concurrent drains on other channels cannot race it.
            ecn = q.occupancy >= q.policy.ecn_threshold
            q.aimd.on_ack(ecn)
            q.backlog_limit = q.policy.backlog_limit(q.aimd.cw)
            ch.stats.note_trigger(trigger)
        if _obs.METRICS:
            # recorded BEFORE the futures resolve: a caller woken by its
            # future may snapshot immediately, and the batch that woke it
            # must already be in the histograms
            app = ch.netfilter.app_name
            t_done = self._clock()
            q.h_wait.observe(max(0.0, t_start - entries[0][2]) * 1e6)
            q.h_lat.observe_many(
                [(t_done - ts) * 1e6 for _, _, ts in entries])
            _obs.drain_trigger(app, trigger)
            _obs.aimd_update(app, q.aimd.cw, ecn)
        # the worker loop deliberately swallows the return value, so
        # the outcome (including a trailing-flush failure, charged to the
        # last call) must be fully delivered through the futures
        resolve_futures([(fut, p) for fut, p, _ in entries], exc)
        if ctx is not None:
            _trace.drain_event(ch.netfilter.app_name, t_drain_us,
                               len(entries), trigger)
            _trace.end(ctx)
        return exc

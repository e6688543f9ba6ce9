"""Multi-application INC data plane (paper §3.2, §5.2.2).

One switch program serves every application: apps register with the
controller, get a GAID and a switch-memory partition (FCFS), and share the
same set of RIPs — start/stop never reboots the data plane. Leaked
partitions (host crash before release) are reclaimed by the two-level
timeout: the controller polls per-GAID last-use timestamps; a stale app's
INC map is first retrieved to its server agent (level 1), and after a
longer period the saved items are delivered to the user stub or deleted
(level 2).

On the card the analogue holds: channels are named INC streams (gradients,
metrics, agreement, KV) sharing one mesh; registration reserves register-
file partitions, and reclaim keeps long-running serving jobs from pinning
device memory for dead clients.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.inc_map import ClientAgent, ServerAgent, SwitchMemory
from repro_torch.core.netfilter import NetFilter


DRAIN_TRIGGERS = ("size", "time", "window", "flush", "inline")


@dataclass
class ChannelStats:
    calls: int = 0
    inc_bytes: int = 0
    host_bytes: int = 0
    batches: int = 0          # pipeline passes (a batch of N calls is one)
    max_batch: int = 0        # largest coalesced batch seen
    # caller-built passes (Stub.call / Stub.call_batch) vs runtime-coalesced
    # drains (submit/call_async queues): a stream of N=1 explicit calls must
    # not dilute the coalescing efficiency the drain counters report.
    explicit_calls: int = 0
    explicit_batches: int = 0
    drained_calls: int = 0
    drained_batches: int = 0
    # async-runtime scheduling behavior (per-GAID): queue depth and which
    # trigger fired each drain (see core/runtime.py)
    queue_depth: int = 0
    max_queue_depth: int = 0
    drain_triggers: dict = field(
        default_factory=lambda: {t: 0 for t in DRAIN_TRIGGERS})
    admission_waits: int = 0  # submitters blocked by AIMD backpressure
    # GPV wire-path coverage: calls whose addTo stream travelled as an
    # array-native TensorSegment (vs the per-element dict path), and the
    # total elements marshalled that way — scheduling_report() surfaces
    # these so a payload silently falling off
    # the fast path is visible
    gpv_calls: int = 0
    gpv_elems: int = 0
    # client-side local aggregation (Agg[...](local_accum=N)): calls folded
    # into switch-bound updates, and the flushes that carried them.  Every
    # flush absorbs >=1 call, so local_folds >= flushes and the two are
    # zero together — check_consistent() audits that pairing.
    local_folds: int = 0
    flushes: int = 0

    @property
    def mean_batch(self) -> float:
        return self.calls / self.batches if self.batches else 0.0

    @property
    def mean_explicit_batch(self) -> float:
        return (self.explicit_calls / self.explicit_batches
                if self.explicit_batches else 0.0)

    @property
    def mean_drained_batch(self) -> float:
        return (self.drained_calls / self.drained_batches
                if self.drained_batches else 0.0)

    def note_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.max_queue_depth = max(self.max_queue_depth, depth)

    def note_trigger(self, trigger: str) -> None:
        # strict: a typo'd trigger name in a new drain path must fail loudly
        # instead of silently growing a phantom row in the report
        if trigger not in self.drain_triggers:
            raise ValueError(
                f"unknown drain trigger {trigger!r}; known triggers: "
                f"{DRAIN_TRIGGERS}")
        self.drain_triggers[trigger] += 1

    def check_consistent(self) -> None:
        """Every pipeline pass is attributed to exactly one source, so the
        split counters must tile the totals: drained + explicit == total
        for both calls and batches.  Raises AssertionError on drift (a
        double-count or a missed attribution in a new entry point)."""
        if (self.drained_calls + self.explicit_calls != self.calls
                or self.drained_batches + self.explicit_batches
                != self.batches):
            raise AssertionError(
                f"ChannelStats attribution drift: drained_calls="
                f"{self.drained_calls} + explicit_calls="
                f"{self.explicit_calls} != calls={self.calls} (or "
                f"drained_batches={self.drained_batches} + "
                f"explicit_batches={self.explicit_batches} != "
                f"batches={self.batches}) — a pipeline entry point "
                f"double-counted or skipped its source attribution")
        # local-aggregation pairing: folded calls are only counted when
        # their flush executes, so a flush with zero folds (or folds with
        # no flush) means a fold path skipped its accounting
        if (self.local_folds < self.flushes
                or (self.flushes == 0) != (self.local_folds == 0)):
            raise AssertionError(
                f"ChannelStats fold drift: local_folds={self.local_folds} "
                f"vs flushes={self.flushes} — every fold flush must absorb "
                f">=1 call and count both at flush time")


class Channel:
    """One application's INC connection: NetFilter + agents + partition.

    ``pending`` is the channel's micro-batching queue: NetRPC.submit
    enqueues (ticket, planned call) pairs here — possibly from many stubs
    and methods of the app — and NetRPC.drain executes each channel's queue
    as one pipeline batch.
    """

    def __init__(self, gaid: int, nf: NetFilter, server: ServerAgent,
                 controller: "Controller"):
        self.gaid = gaid
        self.netfilter = nf
        self.server = server
        self.controller = controller
        self.clients: list[ClientAgent] = []
        self.stats = ChannelStats()
        self.app_type = nf.app_type()
        self.pending: list = []
        # the channel-scoped plane lock: every pipeline pass on this
        # channel (inline Stub.call, scheduled drain, nested handler
        # follow-up) runs under it, so one channel's data plane is always
        # serial while passes on *other* channels proceed concurrently
        # (the sharded plane of core/runtime.py). Re-entrant: a handler's
        # inline call on its own channel nests inside the owning pass.
        self.plane = threading.RLock()
        # per-channel auto-drain override (a runtime DrainPolicy), set by
        # the schema layer's @inc.service/@inc.rpc drain= option; None ->
        # the runtime's default policy
        self.drain_policy = None
        # the ordered update buffer of the pipeline pass currently
        # executing on this channel (rpc._run_pipeline): a nested pass —
        # a handler's inline follow-up call — flushes it on entry so it
        # observes the enclosing pass's buffered addTo/clear updates
        self.active_buf = None
        # client-side local aggregation (local_accum=N): per-method fold
        # buffers (rpc._FoldBuffer) holding calls not yet bound for the
        # switch.  Guarded by fold_lock, which is always taken *before*
        # plane (fold-accept never runs inside a pipeline pass).
        self.folds: dict[str, object] = {}
        self.fold_lock = threading.Lock()
        # fold buffers popped from ``folds`` whose representative is not
        # queued yet: counted at the pop, under fold_lock, and uncounted
        # once dispatched (rpc.NetRPC._dispatch_sealed); the scheduler's
        # issue-order barrier waits on ``sealed`` until none is in flight
        self.sealing = 0
        self.sealed = threading.Condition(self.fold_lock)

    def client(self) -> ClientAgent:
        c = ClientAgent(self.server)
        self.clients.append(c)
        return c

    def take_pending(self) -> list:
        taken, self.pending = self.pending, []
        return taken

    def touch(self) -> None:
        self.controller.touch(self.gaid)

    def close(self) -> None:
        self.controller.release(self.gaid)


class Controller:
    """System-wide registration / name lookup / memory + timeout manager."""

    def __init__(self, switch: SwitchMemory | None = None,
                 t1: float = 60.0, t2: float = 600.0,
                 clock: Callable[[], float] | None = None, device=None):
        # ``device`` places a new switch (default: the card); a given
        # switch brings its own
        self.switch = switch or SwitchMemory(device=device)
        self.t1 = t1            # first-level timeout: retrieve to server
        self.t2 = t2            # second-level: deliver-or-delete
        self._clock = clock or (lambda: 0.0)
        self._now = 0.0
        self._gaids = itertools.count(1)
        self.channels: dict[int, Channel] = {}
        self.by_name: dict[str, int] = {}
        self.last_use: dict[int, float] = {}
        self.retrieved: dict[int, float] = {}     # gaid -> level-1 time
        self.delivered: dict[int, dict] = {}      # level-2 mailbox

    def now(self) -> float:
        return max(self._clock(), self._now)

    def advance(self, dt: float) -> None:        # virtual clock for tests
        self._now = self.now() + dt

    # -- registration -------------------------------------------------------

    def register(self, nf: NetFilter, n_slots: int = 4096,
                 cache_policy: str = "netrpc-lru",
                 device: bool = False) -> Channel:
        if nf.app_name in self.by_name:
            raise ValueError(f"app {nf.app_name!r} already registered")
        gaid = next(self._gaids)
        server = ServerAgent(self.switch, gaid, n_slots, policy=cache_policy,
                             device=device)
        ch = Channel(gaid, nf, server, self)
        self.channels[gaid] = ch
        self.by_name[nf.app_name] = gaid
        self.last_use[gaid] = self.now()
        return ch

    def lookup(self, app_name: str) -> Channel:
        return self.channels[self.by_name[app_name]]

    def touch(self, gaid: int) -> None:
        self.last_use[gaid] = self.now()
        self.retrieved.pop(gaid, None)

    def release(self, gaid: int) -> None:
        ch = self.channels.pop(gaid, None)
        if ch is None:
            return
        self.by_name.pop(ch.netfilter.app_name, None)
        self.switch.release(gaid)
        self.last_use.pop(gaid, None)
        self.retrieved.pop(gaid, None)

    # -- two-level timeout reclaim ------------------------------------------

    def poll(self) -> list[tuple[int, int]]:
        """Periodic controller poll. Returns [(gaid, level)] events."""
        events = []
        t = self.now()
        for gaid, ch in list(self.channels.items()):
            idle = t - self.last_use.get(gaid, t)
            if gaid in self.retrieved:
                if t - self.retrieved[gaid] >= self.t2 - self.t1:
                    # level 2: deliver saved items to the stub (or drop) and
                    # release the partition
                    self.delivered[gaid] = dict(ch.server.spill)
                    self.release(gaid)
                    events.append((gaid, 2))
            elif idle >= self.t1:
                # level 1: retrieve the app's INC map into the server agent
                ch.server.retrieve_all()
                self.retrieved[gaid] = t
                events.append((gaid, 1))
        return events

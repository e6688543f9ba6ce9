"""Client side of the real wire: ``WireTransport`` + ``RemoteSwitchMemory``.

``WireTransport`` drives the existing ``ClientFlow`` sliding window +
AIMD against *real* ACKs from the switch daemon: ops are encoded once,
fragmented to <= MTU frames, admitted by the congestion window, and
retransmitted per-seq when their (exponentially backed-off, jittered)
RTO fires. A dedicated pump thread owns every socket write and the
reconnect logic; a receiver thread per connection turns ACKs into
``flow.on_ack`` + completed ops. Every wait in this file carries a
deadline — an op past its deadline raises ``TimeoutError`` to its
waiter, so no caller ever hangs on a dead switch.

Failure ladder (DEPLOYMENT.md has the full table):

  frame lost / reordered / duplicated  -> RTO retransmit; the daemon's
                                          per-slot seq keeps addTo
                                          exactly-once
  connection reset                     -> reconnect + replay in-flight
                                          (slot seqs persist daemon-side,
                                          so replay is idempotent)
  live TCP pipe, no ACKs               -> ACK-silence watchdog tears the
                                          connection down and reconnects
  op past its deadline                 -> TimeoutError to that caller
  switch unreachable past threshold    -> transport degrades; the
                                          RemoteSwitchMemory falls back to
                                          its host-side local plane and
                                          scheduling_report() says so

``RemoteSwitchMemory`` subclasses ``SwitchMemory``: the inherited local
segments are the *fallback plane* (and the partition mirror — RESERVE
replies carry the daemon's partition start so logical->physical mapping
agrees across every client process), while the hot verbs (addto,
addto_f32, get, read_f32, clear) route over the wire. addTo streams are
pipelined (fire-and-forget under the window); reads and clears barrier
on all prior seqs first, which is what makes read-your-writes hold even
when the fault proxy reorders frames.

The port's copy of ``repro/net/client.py``: ``WireTransport`` is the
reference's; ``RemoteSwitchMemory`` takes ``device=``, where its local
segments (the partition mirror and the fallback plane) live, and
``read_f32`` returns an fp32 tensor on that device.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core.inc_map import SwitchMemory
from repro_torch.core.transport import ClientFlow, W_MAX_DEFAULT
from repro_torch.net import protocol as proto
from repro_torch.obs import hooks as _obs


class WireError(ConnectionError):
    """Transport-level failure (unreachable, degraded, closed)."""


class _Op:
    __slots__ = ("seq", "blob", "deadline", "done", "error", "result")

    def __init__(self, seq: int, blob: bytes, deadline: float):
        self.seq = seq
        self.blob = blob
        self.deadline = deadline
        self.done = False
        self.error: BaseException | None = None
        self.result: bytes = b""


class WireTransport:
    """One reliable flow to the switch daemon over TCP or a Unix socket."""

    def __init__(self, address: tuple[str, int] | str, flow_id: int = 1,
                 w_max: int = W_MAX_DEFAULT, mtu: int = proto.MTU_DEFAULT,
                 rto_base: float = 0.05, call_timeout: float = 30.0,
                 connect_timeout: float = 2.0,
                 reconnect_backoff: float = 0.05,
                 unreachable_after: float = 5.0,
                 backlog_factor: int = 4,
                 ack_silence: float | None = None):
        self.address = address
        self.mtu = mtu
        self.call_timeout = call_timeout
        self.connect_timeout = connect_timeout
        self.reconnect_backoff = reconnect_backoff
        self.unreachable_after = unreachable_after
        self.ack_silence = (ack_silence if ack_silence is not None
                            else max(1.0, 10.0 * rto_base))
        self._cond = threading.Condition()
        self._last_rx = time.monotonic()
        self.flow = ClientFlow(flow_id, 0, w_max=w_max, rto_base=rto_base)
        self.flow.clock = time.monotonic()
        self.backlog_limit = max(w_max * backlog_factor, 16)
        self._ops: dict[int, _Op] = {}
        self._sock = None
        self._send_lock = threading.Lock()
        self._gen = 0                       # connection generation
        self._connected = False
        self._down_since: float | None = None
        self._next_backoff = reconnect_backoff
        self._not_before = 0.0              # reconnect pacing
        self.degraded = False
        self.closed = False
        self.reconnects = -1                # first connect is not a reconnect
        self._ctrl_replies: list[dict] = []
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name=f"wire-pump-{flow_id}")
        self._pump.start()

    # -- public API ----------------------------------------------------------

    def submit(self, op: str, meta: dict, arrays: list,
               timeout: float | None = None) -> _Op:
        """Queue one reliable op; returns a handle to ``wait()`` on. The
        submission itself blocks only on backlog (window * factor), with
        the op deadline as its bound."""
        blob = proto.encode_op(op, meta, arrays)
        deadline = time.monotonic() + (timeout or self.call_timeout)
        with self._cond:
            # NB: _until() caps each wait at 0.1s so state is re-checked
            # frequently — a wait returning False is a tick, not the
            # deadline; only the clock decides the timeout
            while (self.flow.n - self.flow.base) >= self.backlog_limit:
                self._check_usable()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"wire op {op!r} timed out in the backlog queue")
                self._cond.wait(self._until(deadline))
            self._check_usable()
            seq = self.flow.n
            self.flow.n += 1
            handle = _Op(seq, blob, deadline)
            self._ops[seq] = handle
            self._cond.notify_all()
        return handle

    def wait(self, handle: _Op) -> tuple[dict, list[np.ndarray]]:
        """Block until the op is ACKed, its deadline passes, or the
        transport dies. Decodes the ACK result payload."""
        with self._cond:
            while not handle.done and handle.error is None:
                if self.closed or self.degraded:
                    handle.error = WireError(
                        "wire transport closed" if self.closed
                        else "switch unreachable: transport degraded")
                    break
                if time.monotonic() >= handle.deadline:
                    handle.error = TimeoutError(
                        f"wire op seq={handle.seq} missed its deadline "
                        f"(switch slow or unreachable)")
                    break
                self._cond.wait(self._until(handle.deadline))
        if handle.error is not None:
            raise handle.error
        if not handle.result:
            return {}, []
        _, meta, arrays = proto.decode_op(handle.result)
        return meta, arrays

    def call(self, op: str, meta: dict, arrays: list,
             timeout: float | None = None) -> tuple[dict, list[np.ndarray]]:
        return self.wait(self.submit(op, meta, arrays, timeout))

    def barrier(self, timeout: float | None = None) -> None:
        """Wait until every submitted op is ACKed — the read-your-writes
        fence the reads take before leaving the client."""
        deadline = time.monotonic() + (timeout or self.call_timeout)
        with self._cond:
            while self.flow.base < self.flow.n:
                self._check_usable()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"wire barrier timed out with "
                        f"{self.flow.n - self.flow.base} ops unACKed")
                self._cond.wait(self._until(deadline))

    def ctrl(self, cmd: str, expect_reply: bool = True,
             timeout: float | None = None, **kw) -> dict:
        """Control-plane request (ping/stats/crash/shutdown). Sent outside
        the reliable window — control frames are never fault-injected."""
        deadline = time.monotonic() + (timeout or self.call_timeout)
        with self._cond:
            while not self._connected:
                self._check_usable()
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ctrl {cmd!r}: not connected")
                self._cond.wait(self._until(deadline))
            sock = self._sock
            n_seen = len(self._ctrl_replies)
        with self._send_lock:
            sock.sendall(proto.ctrl_frame({"cmd": cmd, **kw}))
        if not expect_reply:
            return {}
        with self._cond:
            while len(self._ctrl_replies) <= n_seen:
                self._check_usable()
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ctrl {cmd!r}: no reply")
                self._cond.wait(self._until(deadline))
            return self._ctrl_replies[-1]

    def report(self) -> dict:
        """The per-flow wire story for scheduling_report()['__wire__']."""
        with self._cond:
            f = self.flow
            return {
                "flow": f.flow,
                "address": str(self.address),
                "connected": self._connected,
                "degraded": self.degraded,
                "cw": f.aimd.cw,
                "acks": f.aimd.acks,
                "ecn_marks": f.aimd.ecn_marks,
                "sent": f.sent_total,
                "retx": f.retx_total,
                "acked": len(f.acked),
                "in_flight": len(f.in_flight),
                "queued": f.n - f.next_seq,
                "reconnects": max(self.reconnects, 0),
            }

    def close(self) -> None:
        with self._cond:
            if self.closed:
                return
            self.closed = True
            self._cond.notify_all()
        self._pump.join(timeout=5)
        with self._cond:
            self._teardown_socket()
            for op in self._ops.values():
                if not op.done and op.error is None:
                    op.error = WireError("wire transport closed")
            self._ops.clear()
            self._cond.notify_all()

    def __enter__(self) -> "WireTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _until(deadline: float) -> float:
        return max(0.0, min(deadline - time.monotonic(), 0.1))

    def _check_usable(self) -> None:
        if self.closed:
            raise WireError("wire transport closed")
        if self.degraded:
            raise WireError("switch unreachable: transport degraded")

    def _teardown_socket(self) -> None:
        # caller holds _cond
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._connected = False

    def _pump_loop(self) -> None:
        while True:
            with self._cond:
                if self.closed:
                    return
                now = time.monotonic()
                self._expire_ops(now)
                if self.degraded:
                    self._cond.wait(0.2)
                    continue
                # reachability is proven by ACKs, not by TCP accepts (a
                # proxy can accept while the daemon is dead) — degrade on
                # sustained ACK silence since the last disconnect
                if (self._down_since is not None
                        and now - self._down_since >= self.unreachable_after):
                    self._degrade()
                    continue
                connected = self._connected
                frames: list[bytes] = []
                sock = self._sock
                if connected:
                    # ACK-silence watchdog: a half-dead path (TCP pipe up,
                    # nothing answering — e.g. a proxy whose upstream sits
                    # unserved in a listen backlog) yields no EOF, so the
                    # recv loop alone cannot detect it. With ops in flight
                    # and no frame received for ack_silence, force a
                    # teardown; the reconnect path takes over from there.
                    if (self.flow.in_flight
                            and now - self._last_rx >= self.ack_silence):
                        self._teardown_socket()
                        if self._down_since is None:
                            self._down_since = now
                        continue
                    frames = self._gather_frames(now)
                    if not frames:
                        self._cond.wait(self._wait_for(now))
                        continue
            if not connected:
                self._attempt_connect()
            else:
                try:
                    with self._send_lock:
                        for fr in frames:
                            sock.sendall(fr)
                except OSError:
                    self._mark_disconnected()

    def _wait_for(self, now: float) -> float:
        # caller holds _cond: sleep until the next RTO or a short tick
        nd = self.flow.next_deadline()
        if nd is None:
            return 0.1
        return max(0.0, min(nd - now, 0.1))

    def _expire_ops(self, now: float) -> None:
        # caller holds _cond: fail waiters past their deadline, but keep
        # the blobs — an expired op may still be in flight daemon-side and
        # must stay retransmittable so the window can advance exactly-once
        woke = False
        for op in self._ops.values():
            if not op.done and op.error is None and now >= op.deadline:
                op.error = TimeoutError(
                    f"wire op seq={op.seq} missed its deadline "
                    f"(switch slow or unreachable)")
                woke = True
        if woke:
            self._cond.notify_all()

    def _gather_frames(self, now: float) -> list[bytes]:
        # caller holds _cond
        frames: list[bytes] = []
        flow = self.flow
        flow.clock = max(flow.clock, now)
        for pkt in flow.sendable():
            op = self._ops.get(pkt.seq)
            if op is not None:
                frames.extend(proto.op_frames(flow.flow, pkt.seq, pkt.flip,
                                              op.blob, self.mtu))
        for pkt in flow.retransmissions(now):
            op = self._ops.get(pkt.seq)
            if op is None:
                continue
            frames.extend(proto.op_frames(flow.flow, pkt.seq, pkt.flip,
                                          op.blob, self.mtu))
            if _obs.METRICS:
                backoff = min(flow.in_flight[pkt.seq],
                              flow.RTO_MAX_DOUBLINGS)
                _obs.wire_retx(flow.flow, flow.rto_base * (1 << backoff))
        return frames

    def _attempt_connect(self) -> None:
        import socket as _socket
        with self._cond:
            # pace attempts with exponential backoff; the backoff resets
            # only on ACK evidence (_on_ack), so a dead-upstream endpoint
            # that still accepts TCP cannot induce a reconnect storm
            now = time.monotonic()
            if now < self._not_before:
                self._cond.wait(min(self._not_before - now, 0.2))
                return
            self._not_before = now + self._next_backoff
            self._next_backoff = min(self._next_backoff * 2, 1.0)
        try:
            if isinstance(self.address, str):
                s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            else:
                s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
            s.settimeout(self.connect_timeout)
            s.connect(self.address)
            s.settimeout(None)
            s.sendall(proto.hello_frame(self.flow.flow, self.flow.w_max))
        except OSError:
            self._note_connect_failure()
            return
        with self._cond:
            if self.closed:
                try:
                    s.close()
                except OSError:
                    pass
                return
            self._sock = s
            self._connected = True
            self._last_rx = time.monotonic()
            self._gen += 1
            gen = self._gen
            self.reconnects += 1
            if self.reconnects > 0:
                # replay everything still unACKed immediately: the daemon's
                # per-slot seqs survived the reset, so replay is idempotent
                for seq in self.flow.in_flight:
                    self.flow.deadline[seq] = 0.0
                if _obs.METRICS:
                    _obs.wire_reconnect(self.flow.flow)
            self._cond.notify_all()
        t = threading.Thread(target=self._recv_loop, args=(s, gen),
                             daemon=True,
                             name=f"wire-recv-{self.flow.flow}-{gen}")
        t.start()

    def _note_connect_failure(self) -> None:
        with self._cond:
            if self._down_since is None:
                self._down_since = time.monotonic()

    def _mark_disconnected(self) -> None:
        with self._cond:
            self._teardown_socket()
            if self._down_since is None:
                self._down_since = time.monotonic()
            self._cond.notify_all()

    def _degrade(self) -> None:
        # caller holds _cond
        self.degraded = True
        self._teardown_socket()
        for op in self._ops.values():
            if not op.done and op.error is None:
                op.error = WireError(
                    "switch unreachable: transport degraded")
        self._ops.clear()
        self._cond.notify_all()

    def _recv_loop(self, sock, gen: int) -> None:
        reasm = proto.Reassembler()
        try:
            for body in proto.iter_frames(sock):
                kind, f = proto.parse_body(body)
                if kind == proto.KIND_ACK:
                    blob = reasm.add(f["flow"], f["seq"], f["frag"],
                                     f["nfrags"], f["payload"])
                    if blob is None:
                        continue
                    self._on_ack(f["seq"], f["ecn"], f["applied"], blob)
                elif kind == proto.KIND_CTRL:
                    with self._cond:
                        self._last_rx = time.monotonic()
                        self._ctrl_replies.append(f)
                        self._cond.notify_all()
        except (ConnectionError, OSError, proto.ProtocolError):
            pass
        finally:
            with self._cond:
                if self._gen == gen and not self.closed:
                    self._teardown_socket()
                    if self._down_since is None:
                        self._down_since = time.monotonic()
                    self._cond.notify_all()

    def _on_ack(self, seq: int, ecn: bool, applied: bool,
                blob: bytes) -> None:
        with self._cond:
            self._last_rx = time.monotonic()
            if seq in self.flow.acked:
                return                       # duplicate ACK
            self.flow.on_ack(seq, ecn)
            # an ACK is end-to-end proof of reachability: clear the
            # outage clock and re-arm the fast reconnect backoff
            self._down_since = None
            self._next_backoff = self.reconnect_backoff
            op = self._ops.pop(seq, None)
            if op is not None and op.error is None:
                op.result = blob
                op.done = True
            if _obs.METRICS:
                _obs.wire_ack(self.flow.flow, self.flow.aimd.cw, ecn)
            self._cond.notify_all()


class RemoteSwitchMemory(SwitchMemory):
    """A ``SwitchMemory`` whose registers live in the switch daemon.

    Drop-in for ``Controller(switch=...)``: typed stubs, ServerAgents and
    the whole pipeline run unchanged — only the physical register verbs
    cross the wire. The inherited local segments double as the partition
    mirror (kept daemon-consistent via RESERVE replies) and as the
    host-side fallback plane for graceful degradation. They live on
    ``device`` (``None``: the card).
    """

    def __init__(self, transport: WireTransport, n_segments: int = 8,
                 seg_slots: int = 40_000, device=None):
        super().__init__(n_segments=n_segments, seg_slots=seg_slots,
                         device=device)
        self.transport = transport
        self.fallback_active = False
        self.fallback_activations = 0
        self._fallback_lock = threading.Lock()

    # -- fallback ladder -----------------------------------------------------

    def _activate_fallback(self) -> None:
        with self._fallback_lock:
            if not self.fallback_active:
                self.fallback_active = True
                self.fallback_activations += 1
                if _obs.METRICS:
                    _obs.wire_fallback(self.transport.flow.flow)

    def _wire(self, remote, local):
        """Run ``remote()`` unless degraded; a *transport* failure (not a
        per-op timeout) activates the host-side fallback plane and serves
        ``local()`` instead. Per-op TimeoutErrors propagate to the caller
        (they surface as IncFuture exceptions — never a hang)."""
        if self.fallback_active:
            return local()
        try:
            return remote()
        except WireError:
            self._activate_fallback()
            return local()

    def report(self) -> dict:
        rep = self.transport.report()
        rep["fallback_active"] = self.fallback_active
        rep["fallback_activations"] = self.fallback_activations
        return rep

    # -- SwitchMemory verbs over the wire ------------------------------------

    def reserve(self, gaid: int, n_slots: int, device: bool = False) -> bool:
        # the daemon is host-resident; device lanes stay an in-process
        # feature, so the local mirror also reserves host-flavored
        def remote() -> bool:
            meta, _ = self.transport.call(
                proto.OP_RESERVE, {"gaid": gaid, "n_slots": n_slots}, [])
            if (meta.get("n_segments") != self.n_segments
                    or meta.get("seg_slots") != self.seg_slots):
                raise ValueError(
                    f"switch geometry mismatch: daemon is "
                    f"{meta.get('n_segments')}x{meta.get('seg_slots')}, "
                    f"client mirror is {self.n_segments}x{self.seg_slots}")
            if not meta["ok"]:
                return False
            self._mirror_partition(gaid, int(meta["start"]), n_slots)
            return True

        return self._wire(remote,
                          lambda: super(RemoteSwitchMemory, self).reserve(
                              gaid, n_slots, device=False))

    def _mirror_partition(self, gaid: int, start: int, n_slots: int) -> None:
        """Adopt the daemon's FCFS placement so every client process maps
        logical->physical identically (and the fallback plane stays
        addressable at the same range)."""
        with self._alloc_lock:
            self.partitions[gaid] = (start, n_slots)
            self._next_free = max(self._next_free, start + n_slots)

    def release(self, gaid: int) -> None:
        super().release(gaid)
        if not self.fallback_active:
            try:
                self.transport.submit(proto.OP_RELEASE, {"gaid": gaid}, [])
            except (WireError, TimeoutError):
                pass                         # release is best-effort

    @staticmethod
    def _phys_op(phys: np.ndarray) -> tuple[dict, list]:
        """(meta, arrays-prefix) for a physical-address operand. GPV
        streams address contiguous ranges; those ship as a two-int
        ``dense`` meta instead of an 8-byte-per-slot address array (the
        daemon regenerates the range — see SwitchServer._phys_arg)."""
        phys = np.asarray(phys, np.int64)
        n = len(phys)
        if n and int(phys[-1]) - int(phys[0]) == n - 1 \
                and (n == 1 or bool((phys[1:] - phys[:-1] == 1).all())):
            return {"dense": [int(phys[0]), n]}, []
        return {}, [phys]

    def addto(self, phys: np.ndarray, vals: np.ndarray) -> None:
        if not len(phys):
            return
        meta, arrays = self._phys_op(phys)
        arrays = arrays + [np.asarray(vals, np.int32)]
        self._wire(
            lambda: self.transport.submit(proto.OP_ADDTO, meta, arrays),
            lambda: super(RemoteSwitchMemory, self).addto(phys, vals))

    def addto_f32(self, phys: np.ndarray, fvals: np.ndarray, scale) -> None:
        if not len(phys):
            return
        meta, arrays = self._phys_op(phys)
        meta["scale"] = float(scale)
        arrays = arrays + [np.asarray(fvals, np.float32)]
        self._wire(
            lambda: self.transport.submit(proto.OP_ADDTO_F32, meta, arrays),
            lambda: super(RemoteSwitchMemory, self).addto_f32(
                phys, fvals, scale))

    def get(self, phys: np.ndarray) -> np.ndarray:
        if not len(phys):
            return np.zeros(0, np.int32)

        def remote() -> np.ndarray:
            self.transport.barrier()         # read-your-writes fence
            meta, arrays = self._phys_op(phys)
            _, out = self.transport.call(proto.OP_READ, meta, arrays)
            return np.asarray(out[0], np.int32)

        return self._wire(remote,
                          lambda: super(RemoteSwitchMemory, self).get(phys))

    def read_f32(self, phys: np.ndarray, scale, need_raw: bool = False):
        if self.fallback_active:
            return super().read_f32(phys, scale, need_raw)
        raw = self.get(phys)
        if self.fallback_active:             # degraded mid-read
            return super().read_f32(phys, scale, need_raw)
        inv = np.float32(1.0) / np.float32(scale)
        vals = torch.from_numpy(raw.astype(np.float32) * inv).to(self.device)
        return vals, (raw if need_raw else None)

    def clear(self, phys: np.ndarray) -> None:
        if not len(phys):
            return

        def remote() -> None:
            self.transport.barrier()         # order the clear after writes
            meta, arrays = self._phys_op(phys)
            self.transport.call(proto.OP_CLEAR, meta, arrays)

        self._wire(remote,
                   lambda: super(RemoteSwitchMemory, self).clear(phys))

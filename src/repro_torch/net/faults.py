"""Deterministic fault injection for the wire transport (a copy of the JAX
package's ``repro/net/faults.py``).

``FaultProxy`` sits between a client and the switch daemon as a
frame-aware TCP proxy: it parses the length-prefixed frame stream and
applies a *seeded* fault schedule to whole frames — drop, duplicate,
hold-back reorder, delay, and connection reset — so every chaos run is
reproducible from its seed. Faults apply only to data frames (OP/ACK);
HELLO and CTRL frames always pass, mirroring the paper's split between
the lossy data plane and the reliable control plane.

Switch crash/restart is injected at the daemon itself
(``SwitchServer.crash`` for an endpoint failure with surviving state,
SIGTERM + respawn of ``launch/switchd.py`` for a full process restart
with a state spool).
"""
from __future__ import annotations

import random
import socket
import threading
import time
from dataclasses import dataclass, field

from repro_torch.net import protocol as proto
from repro_torch.net.server import _close


@dataclass
class FaultSpec:
    seed: int = 0
    loss: float = 0.0            # P(drop a data frame)
    dup: float = 0.0             # P(send a data frame twice)
    reorder: float = 0.0         # P(hold a frame back past the next one)
    delay: float = 0.0           # max uniform extra delay per frame (s)
    reset_after: int | None = None   # reset the conn after N data frames
    direction: str = "both"      # "both" | "c2s" | "s2c"

    def applies(self, c2s: bool) -> bool:
        return (self.direction == "both"
                or self.direction == ("c2s" if c2s else "s2c"))


@dataclass
class FaultStats:
    frames: int = 0
    dropped: int = 0
    duplicated: int = 0
    reordered: int = 0
    delayed: int = 0
    resets: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)

    def snapshot(self) -> dict:
        with self.lock:
            return {"frames": self.frames, "dropped": self.dropped,
                    "duplicated": self.duplicated,
                    "reordered": self.reordered, "delayed": self.delayed,
                    "resets": self.resets}


class _Shuttle:
    """One direction of one proxied connection."""

    def __init__(self, src: socket.socket, dst: socket.socket,
                 spec: FaultSpec, rng: random.Random, c2s: bool,
                 stats: FaultStats, pair_close):
        self.src, self.dst = src, dst
        self.spec, self.rng, self.c2s = spec, rng, c2s
        self.stats = stats
        self.pair_close = pair_close
        self.held: bytes | None = None      # the reorder hold-back slot
        self.data_frames = 0

    def run(self) -> None:
        try:
            while True:
                body = proto.read_frame(self.src)
                self._forward(body)
        except (ConnectionError, OSError, proto.ProtocolError):
            pass
        finally:
            if self.held is not None:
                try:
                    self._send(self.held)
                except OSError:
                    pass
                self.held = None
            self.pair_close()

    def _forward(self, body: bytes) -> None:
        kind = body[0]
        faultable = (kind in (proto.KIND_OP, proto.KIND_ACK)
                     and self.spec.applies(self.c2s))
        with self.stats.lock:
            self.stats.frames += 1
        if not faultable:
            self._flush_held()
            self._send(body)
            return
        self.data_frames += 1
        spec, rng = self.spec, self.rng
        if (spec.reset_after is not None
                and self.data_frames > spec.reset_after):
            with self.stats.lock:
                self.stats.resets += 1
            raise ConnectionError("injected reset")
        if spec.delay and rng.random() < 0.5:
            with self.stats.lock:
                self.stats.delayed += 1
            time.sleep(rng.uniform(0.0, spec.delay))
        if rng.random() < spec.loss:
            with self.stats.lock:
                self.stats.dropped += 1
            self._flush_held()
            return
        if self.held is None and rng.random() < spec.reorder:
            self.held = body
            with self.stats.lock:
                self.stats.reordered += 1
            return
        self._send(body)
        self._flush_held()
        if rng.random() < spec.dup:
            with self.stats.lock:
                self.stats.duplicated += 1
            self._send(body)

    def _flush_held(self) -> None:
        if self.held is not None:
            held, self.held = self.held, None
            self._send(held)

    def _send(self, body: bytes) -> None:
        self.dst.sendall(proto.pack_frame(body))


class FaultProxy:
    """Frame-level fault-injecting proxy in front of a ``SwitchServer``.

    ``connect()`` against ``proxy.address`` instead of the daemon's; every
    accepted connection gets its own deterministic rng derived from
    ``spec.seed`` and the connection index, so runs replay exactly."""

    def __init__(self, upstream: tuple[str, int] | str,
                 spec: FaultSpec | None = None, host: str = "127.0.0.1"):
        self.upstream = upstream
        self.spec = spec or FaultSpec()
        self.stats = FaultStats()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self.address = self._sock.getsockname()
        self._conn_ix = 0
        self._pairs: list[tuple[socket.socket, socket.socket]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> "FaultProxy":
        t = threading.Thread(target=self._accept_loop,
                             name="faultproxy-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        _close(self._sock)
        with self._lock:
            pairs, self._pairs = list(self._pairs), []
        for a, b in pairs:
            _close(a)
            _close(b)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)

    def __enter__(self) -> "FaultProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                continue
            try:
                if isinstance(self.upstream, str):
                    up = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                else:
                    up = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                up.settimeout(2.0)
                up.connect(self.upstream)
                up.settimeout(None)
            except OSError:
                _close(client)
                continue
            with self._lock:
                ix = self._conn_ix
                self._conn_ix += 1
                self._pairs.append((client, up))
            closed = threading.Event()

            def pair_close(client=client, up=up, closed=closed):
                if not closed.is_set():
                    closed.set()
                    _close(client)
                    _close(up)

            for c2s, src, dst in ((True, client, up), (False, up, client)):
                rng = random.Random(self.spec.seed * 1000003
                                    + ix * 2 + int(c2s))
                sh = _Shuttle(src, dst, self.spec, rng, c2s, self.stats,
                              pair_close)
                t = threading.Thread(target=sh.run, daemon=True,
                                     name=f"faultproxy-{ix}-"
                                          f"{'c2s' if c2s else 's2c'}")
                t.start()
                self._threads.append(t)

"""The switch daemon: ``SwitchMemory`` + per-flow idempotency arrays
behind a socket.

One ``SwitchServer`` owns the register file and the reliability state.
Clients HELLO with a flow id; the flow's idempotency array lives in the
*server*, keyed by flow — not by connection — so it persists across
reconnects and a replayed in-flight op is recognized as a duplicate by
construction (§5.1 made real). A graceful shutdown can spool the whole
switch state (registers, partitions, idempotency arrays) to disk and a
restarted daemon reloads it, which is how the CI wire lane survives a
mid-run switch restart without double-applying a single addTo.

The register file lives on ``device`` (the card unless the caller asks
for the CPU): every segment is an int32 CUDA tensor, so each addTo frame
runs the ``sparse_addto`` kernel from the handler thread of its
connection. The spool keeps the JAX package's layout (numpy int32 regs,
through ``to_jax_state`` / ``from_jax_state``), so a spool that either
package's daemon writes restores in the other's.

Two deliberate departures from the reference (``repro/net/server.py``):

- ``stop()`` closes the listener and every connection and joins the
  handler threads *before* it writes the spool. The reference spools
  first, so an op applied and ACKed between the snapshot and the close
  is lost across a SIGTERM and respawn, and the client never replays it
  (it was ACKed).
- An exception from ``_apply`` (a kernel wrapper's ``RuntimeError``, a
  bad index) is fatal and visible: the slot seq was recorded before the
  apply, so a replay would be skipped as a duplicate and the effect lost
  without a word. The daemon records the error in ``error``, sends no
  ACK, stops without spooling, and ``launch/switchd.py`` exits non-zero.

The daemon hardens the paper's 1-bit-per-slot scheme to 32 bits per
slot: it records the *last applied seq* per window slot and applies an
op iff ``seq > slot_seq[seq % w_max]``. The flip bit alone is provably
exactly-once only on a FIFO path (a P4 pipeline is one; §5.1's
induction silently relies on it) — behind a reordering network a stale
retransmitted copy of seq s that overtakes seq s+w_max flips the slot
back, double-applying s and then falsely skipping the next window's op
on that slot. The per-slot seq is immune: the window invariant (s in
flight only when s-w_max is ACKed) guarantees any seq greater than the
slot's record is a genuine first appearance, under arbitrary loss,
duplication, and reordering. Frames still carry the flip bit for
debuggability; the daemon does not trust it.

ECN follows the simulator's model: a shared ingress queue of not-yet-
dispatched fragments marks ECN above a threshold, and the mark is
*persisted* (the reserved-map-key trick) until the queue drains below
it, so retransmitted ACKs keep carrying the signal.
"""
from __future__ import annotations

import os
import pickle
import socket
import threading
import time
import traceback

import numpy as np

from repro_torch.core.inc_map import (SwitchMemory, from_jax_state,
                                      to_jax_state)
from repro_torch.core.transport import W_MAX_DEFAULT
from repro_torch.net import protocol as proto


class SwitchServer:
    """Threaded switch daemon: one accept loop, one handler per client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 uds_path: str | None = None, w_max: int = W_MAX_DEFAULT,
                 mtu: int = proto.MTU_DEFAULT, n_segments: int = 8,
                 seg_slots: int = 40_000, ecn_threshold: int = 48,
                 state_spool: str | None = None, track_effects: bool = False,
                 device=None):
        self.w_max = w_max
        self.mtu = mtu
        self.ecn_threshold = ecn_threshold
        self.state_spool = state_spool
        self.track_effects = track_effects
        self.switch = SwitchMemory(n_segments=n_segments,
                                   seg_slots=seg_slots, device=device)
        # the first exception an op raised in _apply (None while healthy);
        # once set the daemon has stopped and writes no spool
        self.error: str | None = None
        self._lock = threading.Lock()
        # flow -> w_max last-applied seqs (-1 = slot never used); the
        # reorder-safe widening of the paper's flip bit (see module doc)
        self.slot_seq: dict[int, list[int]] = {}
        self.queue_len = 0                         # undispatched fragments
        self.ecn_persist = False                   # the persisted ECN mark
        self.stats = {"frames_in": 0, "ops": 0, "effects_applied": 0,
                      "dup_skips": 0, "ecn_marks": 0, "connections": 0,
                      "crashes": 0}
        self.effect_counts: dict[str, int] = {}    # "flow:seq" -> applies
        self._reasm = proto.Reassembler()
        self._conns: list[socket.socket] = []
        self._down_until = 0.0
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._threads: list[threading.Thread] = []    # handler threads

        if state_spool and os.path.exists(state_spool):
            self._load_state(state_spool)
        if uds_path is not None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            if os.path.exists(uds_path):
                os.unlink(uds_path)
            self._sock.bind(uds_path)
            self.address: tuple[str, int] | str = uds_path
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self.address = self._sock.getsockname()
        self._sock.listen(64)
        self._sock.settimeout(0.2)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SwitchServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="switchd-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self, spool: bool = True) -> None:
        """Stop serving, then spool. The listener goes first and the
        accept loop is joined, so no connection arrives after the
        snapshot of ``_conns``; then every connection is closed and every
        handler joined, so each op either completed its apply (and its
        seq is in the spool with its effect) or was never read (and the
        client replays it). Only then is the state written: the restart-
        spool race of the reference, which spools first, is closed."""
        if self._stop.is_set():
            return
        self._stop.set()
        _close(self._sock)
        me = threading.current_thread()
        if self._accept_thread is not None and self._accept_thread is not me:
            self._accept_thread.join(timeout=5)
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:
            _close(c)
        for t in threads:
            if t is not me:
                t.join(timeout=30)
        if not (spool and self.state_spool):
            return
        if self.error is not None:
            return      # an op failed: its seq is recorded, its effect not
        if any(t.is_alive() for t in threads if t is not me):
            raise RuntimeError("a switchd handler thread did not stop; "
                               "the state is not spooled")
        self._save_state(self.state_spool)

    def __enter__(self) -> "SwitchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def crash(self, down_s: float) -> None:
        """Fail the RPC endpoint for ``down_s``: every connection resets
        and new connects are refused, but the data-plane state (registers
        and per-slot seqs) survives — the reconnect-and-replay surface."""
        with self._lock:
            self._down_until = time.monotonic() + down_s
            conns, self._conns = list(self._conns), []
            self.stats["crashes"] += 1
        for c in conns:
            _close(c)

    # -- state spool ---------------------------------------------------------

    def _save_state(self, path: str) -> None:
        state = to_jax_state(self.switch.state_dict())
        with self._lock:
            state["slot_seq"] = {f: list(b)
                                 for f, b in self.slot_seq.items()}
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(state, fh)
        os.replace(tmp, path)

    def _load_state(self, path: str) -> None:
        with open(path, "rb") as fh:
            state = pickle.load(fh)
        self.switch.load_state(from_jax_state(state))
        with self._lock:
            self.slot_seq = {int(f): list(b)
                             for f, b in state["slot_seq"].items()}

    # -- accept / handler loops ----------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                # a transient per-connection error (e.g. ECONNABORTED for
                # a backlog connection reset before accept) must not kill
                # the listener — only exit once stop() closed it
                if self._stop.is_set():
                    return
                continue
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="switchd-conn", daemon=True)
            with self._lock:
                if (self._stop.is_set()
                        or time.monotonic() < self._down_until):
                    _close(conn)
                    continue
                self._conns.append(conn)
                self.stats["connections"] += 1
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(None)
        send_lock = threading.Lock()
        try:
            for body in proto.iter_frames(conn):
                kind, f = proto.parse_body(body)
                if kind == proto.KIND_HELLO:
                    self._register_flow(f["flow"], f["w_max"])
                elif kind == proto.KIND_OP:
                    self._on_op_frame(conn, send_lock, f)
                elif kind == proto.KIND_CTRL:
                    if not self._on_ctrl(conn, send_lock, f):
                        return
        except (ConnectionError, OSError, proto.ProtocolError):
            pass
        except Exception as exc:    # noqa: BLE001 -- recorded, then fatal
            # A handler thread must not die silently: the slot seq of the
            # op was recorded before its apply, so the client's replay
            # would be skipped as a duplicate and the effect lost. Record
            # the error and stop the daemon (no spool).
            self._fail(exc)
        finally:
            _close(conn)
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self.error is None:
                self.error = "".join(traceback.format_exception(exc))
        threading.Thread(target=self.stop, kwargs={"spool": False},
                         name="switchd-fail-stop", daemon=True).start()

    def _register_flow(self, flow: int, w_max: int) -> None:
        with self._lock:
            seqs = self.slot_seq.setdefault(flow, [-1] * w_max)
            if len(seqs) != w_max:
                raise proto.ProtocolError(
                    f"flow {flow} re-HELLO'd with w_max {w_max}, "
                    f"slots are {len(seqs)}")

    # -- the data path -------------------------------------------------------

    def _on_op_frame(self, conn, send_lock, f: dict) -> None:
        with self._lock:
            self.stats["frames_in"] += 1
            self.queue_len += 1
            if self.queue_len >= self.ecn_threshold and not self.ecn_persist:
                self.ecn_persist = True
                self.stats["ecn_marks"] += 1
            blob = self._reasm.add(f["flow"], f["seq"], f["frag"],
                                   f["nfrags"], f["payload"])
        if blob is None:
            return
        flow, seq = f["flow"], f["seq"]
        op, meta, arrays = proto.decode_op(blob)

        applied = True
        with self._lock:
            seqs = self.slot_seq.setdefault(flow, [-1] * self.w_max)
            slot = seq % len(seqs)
            if op in proto.SIDE_EFFECT_OPS:
                if seq <= seqs[slot]:
                    applied = False       # retx or stale reordered copy
                    self.stats["dup_skips"] += 1
                else:
                    seqs[slot] = seq
        result = b""
        if applied:
            result = self._apply(op, meta, arrays)
            if op in proto.SIDE_EFFECT_OPS:
                with self._lock:
                    self.stats["effects_applied"] += 1
                    if self.track_effects:
                        key = f"{flow}:{seq}"
                        self.effect_counts[key] = \
                            self.effect_counts.get(key, 0) + 1
        elif op not in proto.SIDE_EFFECT_OPS:
            result = self._apply(op, meta, arrays)  # reads re-execute
        with self._lock:
            self.stats["ops"] += 1
            self.queue_len = max(0, self.queue_len - f["nfrags"])
            if self.queue_len < self.ecn_threshold:
                self.ecn_persist = False
            ecn = self.ecn_persist
        frames = proto.ack_frames(flow, seq, ecn, applied, result, self.mtu)
        with send_lock:
            for fr in frames:
                conn.sendall(fr)

    @staticmethod
    def _phys_arg(meta: dict, arrays: list) -> tuple[np.ndarray, list]:
        """The physical-address operand: either ``arrays[0]`` explicit,
        or reconstructed from the ``dense: [start, n]`` meta shorthand
        (GPV streams are contiguous ranges — clients elide the 8-byte-
        per-slot address array and the daemon regenerates it)."""
        dense = meta.get("dense")
        if dense is not None:
            start, n = dense
            return np.arange(start, start + n, dtype=np.int64), arrays
        return np.asarray(arrays[0], np.int64), arrays[1:]

    def _apply(self, op: str, meta: dict, arrays: list) -> bytes:
        sw = self.switch
        if op == proto.OP_ADDTO:
            dense = meta.get("dense")
            if dense is not None:
                sw.addto_dense(dense[0], np.asarray(arrays[0], np.int32))
                return b""
            phys, rest = self._phys_arg(meta, arrays)
            sw.addto(phys, np.asarray(rest[0], np.int32))
            return b""
        if op == proto.OP_ADDTO_F32:
            phys, rest = self._phys_arg(meta, arrays)
            sw.addto_f32(phys, rest[0], np.float32(meta["scale"]))
            return b""
        if op == proto.OP_READ:
            phys, _ = self._phys_arg(meta, arrays)
            raw = sw.get(phys)
            return proto.encode_op("result", {}, [np.asarray(raw, np.int32)])
        if op == proto.OP_CLEAR:
            phys, _ = self._phys_arg(meta, arrays)
            sw.clear(phys)
            return b""
        if op == proto.OP_RESERVE:
            # SwitchMemory.reserve is idempotent per gaid, so a replayed
            # reserve re-returns the same verdict (no flip gating needed).
            # The reply carries the FCFS placement + geometry: every
            # client process mirrors it, so logical->physical mapping
            # agrees across the fleet.
            gaid = meta["gaid"]
            ok = sw.reserve(gaid, meta["n_slots"], device=False)
            reply = {"ok": bool(ok), "n_segments": sw.n_segments,
                     "seg_slots": sw.seg_slots}
            if ok:
                reply["start"] = sw.partitions[gaid][0]
            return proto.encode_op("result", reply, [])
        if op == proto.OP_RELEASE:
            sw.release(meta["gaid"])
            return b""
        raise proto.ProtocolError(f"unknown op {op!r}")

    # -- control plane -------------------------------------------------------

    def _on_ctrl(self, conn, send_lock, f: dict) -> bool:
        cmd = f.get("cmd")
        reply: dict = {"reply_to": cmd, "ok": True}
        if cmd == "ping":
            pass
        elif cmd == "stats":
            with self._lock:
                reply["stats"] = dict(self.stats)
                reply["flows"] = sorted(self.slot_seq)
                reply["queue_len"] = self.queue_len
                reply["ecn"] = self.ecn_persist
                dupes = {k: c for k, c in self.effect_counts.items()
                         if c != 1}
                reply["duplicate_effects"] = dupes
        elif cmd == "crash":
            self.crash(float(f.get("down_ms", 0)) / 1000.0)
            # the crash closed this connection too; no reply can be sent
            return False
        elif cmd == "shutdown":
            threading.Thread(target=self.stop,
                             kwargs={"spool": bool(f.get("spool", True))},
                             daemon=True).start()
        else:
            reply = {"reply_to": cmd, "ok": False, "error": "unknown cmd"}
        with send_lock:
            conn.sendall(proto.ctrl_frame(reply))
        return cmd != "shutdown"


def _close(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass

"""The reliable INC transport (paper §5.1), as a deterministic simulator.

The in-process data plane has no lossy wire, but the *protocol logic* is
the paper's correctness contribution, and the runtime's AIMD window
(core/runtime.py) runs on it. The wire protocol is implemented
bit-for-bit:

  - every packet carries (seq, flip) with flip = (seq / w_max) % 2;
  - the switch keeps ONE bit per in-window slot per flow, initialized to 1;
  - bit == flip  => retransmission => skip side effects (idempotence);
  - bit != flip  => first appearance => set bit = flip, apply side effects.

The induction proof in §5.1 relies on the sender only emitting packet i of
window t after packet i of window t-1 was ACKed — enforced here by the
sliding window.

Congestion control: ECN raised when the switch ingress queue exceeds a
threshold; the ECN bit is *persisted in the INC map under a reserved key*
so retransmissions keep carrying it (loss cannot erase the signal); senders
run AIMD on a window cw <= w_max.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable

W_MAX_DEFAULT = 256
ECN_MAP_KEY = 0xFFFFFFFF  # reserved logical address for the ECN flag


@dataclass
class Packet:
    flow: int
    seq: int
    flip: int
    payload: object = None
    ecn: bool = False
    is_retx: bool = False


class FlipBitSwitch:
    """Per-flow flip-bit arrays + a bounded ingress queue with ECN marking."""

    def __init__(self, w_max: int = W_MAX_DEFAULT, queue_capacity: int = 64,
                 ecn_threshold: int = 48):
        self.w_max = w_max
        self.bits: dict[int, list[int]] = {}
        self.queue_capacity = queue_capacity
        self.ecn_threshold = ecn_threshold
        self.queue_len = 0
        self.inc_map: dict[int, int] = {}   # the on-switch INC map
        self.side_effects = 0               # packets whose effects applied

    def register_flow(self, flow: int) -> None:
        # "Each host agent maintains a fixed number of connections with the
        # switch, even without running tasks" — bits persist across tasks.
        self.bits.setdefault(flow, [1] * self.w_max)

    def ingress(self, pkt: Packet,
                effect: Callable[[Packet], None] | None = None) -> bool:
        """Process one packet. Returns True if its side effect was applied
        (first appearance), False if recognized as a retransmission."""
        self.register_flow(pkt.flow)
        self.queue_len += 1
        if self.queue_len > self.queue_capacity:
            # tail drop happens at the caller (LossyLink); here we only mark
            self.queue_len = self.queue_capacity
        if self.queue_len >= self.ecn_threshold:
            # persist ECN in the INC map under the reserved key so later
            # packets (and retransmissions) keep carrying it (§5.1)
            self.inc_map[ECN_MAP_KEY] = 1
        pkt.ecn = bool(self.inc_map.get(ECN_MAP_KEY, 0))

        slot = pkt.seq % self.w_max
        bits = self.bits[pkt.flow]
        if bits[slot] == pkt.flip:
            return False            # duplicate: skip side effects
        bits[slot] = pkt.flip
        self.side_effects += 1
        if effect is not None:
            effect(pkt)
        return True

    def drain(self, n: int = 1) -> None:
        self.queue_len = max(0, self.queue_len - n)
        if self.queue_len < self.ecn_threshold:
            self.inc_map.pop(ECN_MAP_KEY, None)


def flip_of(seq: int, w_max: int) -> int:
    return (seq // w_max) % 2


@dataclass
class AimdState:
    cw: int = 8
    additive: int = 1
    multiplicative: float = 0.5
    cw_min: int = 1
    cw_max: int = W_MAX_DEFAULT
    # lifetime counters (repro_torch.obs surfaces them: the cw-evolution story
    # is unreadable without knowing how many acks were congestion marks)
    acks: int = 0
    ecn_marks: int = 0

    def on_ack(self, ecn: bool) -> None:
        self.acks += 1
        if ecn:
            self.ecn_marks += 1
            self.cw = max(self.cw_min, int(self.cw * self.multiplicative))
        else:
            self.cw = min(self.cw_max, self.cw + self.additive)


class ClientFlow:
    """Sliding-window sender with AIMD congestion control.

    The invariant backing the §5.1 induction proof: packet i of window t is
    sent only after packet i of window t-1 is ACKed — guaranteed because
    seq s may be in flight only when s - w_max is ACKed (cumulative window).

    Retransmission is timer-driven: each in-flight seq carries its own RTO
    deadline with exponential backoff and jitter, and ``retransmissions()``
    only emits the seqs whose deadline has passed. The clock is virtual by
    default (one tick per ``retransmissions()`` call — the simulator's
    round) and real when the caller passes ``now`` (the wire transport
    passes ``time.monotonic()``).
    """

    RTO_MAX_DOUBLINGS = 6   # backoff cap: rto_base * 2**6

    def __init__(self, flow_id: int, n_packets: int,
                 w_max: int = W_MAX_DEFAULT, rng: random.Random | None = None,
                 rto_base: float = 1.0, rto_jitter: float = 0.5):
        self.flow = flow_id
        self.n = n_packets
        self.w_max = w_max
        self.next_seq = 0
        self.acked: set[int] = set()
        self.in_flight: dict[int, int] = {}   # seq -> retx count
        self.deadline: dict[int, float] = {}  # seq -> RTO expiry
        self.aimd = AimdState(cw_max=w_max)
        self.rng = rng or random.Random(0)
        self.rto_base = rto_base
        self.rto_jitter = rto_jitter
        self.clock = 0.0
        self.base = 0        # cumulative-ack window base, kept incrementally
        self.sent_total = 0
        self.retx_total = 0

    @property
    def done(self) -> bool:
        return len(self.acked) == self.n

    def _window_base(self) -> int:
        return self.base

    def _arm(self, seq: int, now: float) -> None:
        backoff = min(self.in_flight[seq], self.RTO_MAX_DOUBLINGS)
        rto = self.rto_base * (1 << backoff)
        self.deadline[seq] = now + rto + self.rng.random() * \
            self.rto_jitter * rto

    def sendable(self) -> list[Packet]:
        """Fresh packets permitted by min(cw, w_max) from the window base."""
        out = []
        limit = self.base + min(self.aimd.cw, self.w_max)
        while self.next_seq < min(limit, self.n):
            s = self.next_seq
            out.append(Packet(self.flow, s, flip_of(s, self.w_max)))
            self.in_flight[s] = 0
            self._arm(s, self.clock)
            self.next_seq += 1
            self.sent_total += 1
        return out

    def next_deadline(self) -> float | None:
        """Earliest in-flight RTO expiry, or None when nothing is in
        flight (the wire transport sleeps until this)."""
        return min(self.deadline.values()) if self.deadline else None

    def retransmissions(self, now: float | None = None) -> list[Packet]:
        """Seqs whose RTO has expired, with backoff re-armed. With no
        ``now`` the virtual clock advances one tick per call (simulator
        round); with ``now`` the caller owns the clock."""
        if now is None:
            self.clock += 1.0
            now = self.clock
        else:
            self.clock = max(self.clock, now)
        out = []
        for s in sorted(self.in_flight):
            if self.deadline.get(s, 0.0) > now:
                continue
            self.in_flight[s] += 1
            self.retx_total += 1
            self._arm(s, now)
            out.append(Packet(self.flow, s, flip_of(s, self.w_max),
                              is_retx=True))
        return out

    def on_ack(self, seq: int, ecn: bool) -> None:
        if seq in self.acked:
            return
        self.acked.add(seq)
        self.in_flight.pop(seq, None)
        self.deadline.pop(seq, None)
        while self.base in self.acked:
            self.base += 1
        # fast retransmit: an ACK above an in-flight hole is evidence the
        # hole was lost (or its ACK was) — pull its deadline down to one
        # base RTO instead of waiting out the exponential backoff, which
        # otherwise head-of-line-blocks the window for seconds
        for s in self.in_flight:
            if s < seq:
                d = self.clock + self.rto_base
                if self.deadline.get(s, d) > d:
                    self.deadline[s] = d
        self.aimd.on_ack(ecn)


class LossyLink:
    def __init__(self, loss_rate: float, seed: int = 0):
        self.loss_rate = loss_rate
        self.rng = random.Random(seed)
        self.dropped = 0

    def deliver(self, pkt: Packet) -> bool:
        if self.rng.random() < self.loss_rate:
            self.dropped += 1
            return False
        return True


def run_flow(n_packets: int, loss_rate: float, seed: int = 0,
             w_max: int = W_MAX_DEFAULT,
             effect: Callable[[Packet], None] | None = None,
             max_rounds: int = 1_000_000) -> dict:
    """Drive one flow to completion over a lossy link through a flip-bit
    switch. Returns counters proving exactly-once side-effect application."""
    switch = FlipBitSwitch(w_max=w_max)
    flow = ClientFlow(0, n_packets, w_max=w_max)
    link = LossyLink(loss_rate, seed)
    ack_link = LossyLink(loss_rate, seed + 1)
    applied: dict[int, int] = {}

    def _effect(p: Packet) -> None:
        applied[p.seq] = applied.get(p.seq, 0) + 1
        if effect:
            effect(p)

    rounds = 0
    while not flow.done:
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError("flow did not complete")
        batch = flow.sendable() or flow.retransmissions()
        for pkt in batch:
            if not link.deliver(pkt):
                continue
            switch.ingress(pkt, _effect)
            switch.drain()
            if ack_link.deliver(pkt):   # ACK return path can lose too
                flow.on_ack(pkt.seq, pkt.ecn)
    dupes = {s: c for s, c in applied.items() if c != 1}
    return {"applied": applied, "duplicate_effects": dupes,
            "sent": flow.sent_total, "retx": flow.retx_total,
            "dropped": link.dropped, "rounds": rounds,
            "final_cw": flow.aimd.cw}

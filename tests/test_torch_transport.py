"""Flip-bit idempotent retransmission + ECN/AIMD (paper §5.1) in the port.

The nine tests of ``tests/test_transport.py``, against
``repro_torch.core.transport``: under any loss pattern every packet's side
effect is applied exactly once, using only w_max bits of per-flow switch
state. The flow is what the real wire (``repro_torch.net``) drives. One
more test runs the same seeded flows through both packages' simulators
and requires every counter of the result to agree.
"""
from _hypothesis_compat import given, settings, st

from repro_torch.core.transport import (AimdState, ClientFlow, FlipBitSwitch,
                                        Packet, flip_of, run_flow)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 400), st.floats(0.0, 0.6), st.integers(0, 2**16))
def test_exactly_once_under_loss(n_packets, loss, seed):
    res = run_flow(n_packets, loss, seed=seed, w_max=16)
    assert res["duplicate_effects"] == {}
    assert sorted(res["applied"]) == list(range(n_packets))
    assert all(c == 1 for c in res["applied"].values())


def test_lossless_flow_no_retx():
    res = run_flow(100, 0.0)
    assert res["retx"] == 0 and res["dropped"] == 0
    assert len(res["applied"]) == 100


def test_duplicate_detected_by_flip_bit():
    sw = FlipBitSwitch(w_max=8)
    applied = []
    p = Packet(0, 3, flip_of(3, 8))
    assert sw.ingress(p, lambda pkt: applied.append(pkt.seq)) is True
    assert sw.ingress(p, lambda pkt: applied.append(pkt.seq)) is False
    assert applied == [3]


def test_flip_alternates_across_windows():
    w = 4
    assert [flip_of(s, w) for s in range(12)] == [0] * 4 + [1] * 4 + [0] * 4


def test_window_invariant_backs_induction():
    """seq s is only sendable once s - w_max is ACKed (the proof's premise)."""
    flow = ClientFlow(0, 100, w_max=8)
    batch = flow.sendable()
    assert max(p.seq for p in batch) < 8      # window 0 only
    for p in batch:
        flow.on_ack(p.seq, ecn=False)
    batch2 = flow.sendable()
    assert batch2 and max(p.seq for p in batch2) < 16


def test_aimd_additive_increase_multiplicative_decrease():
    a = AimdState(cw=8, cw_max=64)
    a.on_ack(ecn=False)
    assert a.cw == 9
    a.on_ack(ecn=True)
    assert a.cw == 4
    for _ in range(200):
        a.on_ack(ecn=False)
    assert a.cw == 64                         # capped at w_max


def test_ecn_persisted_in_inc_map():
    """ECN is written under the reserved map key so retransmissions keep
    carrying it even if the marked packet is lost (paper §5.1)."""
    sw = FlipBitSwitch(w_max=8, queue_capacity=4, ecn_threshold=2)
    p1 = Packet(0, 0, 0)
    p2 = Packet(0, 1, 0)
    sw.ingress(p1)
    sw.ingress(p2)
    assert p2.ecn                             # queue crossed the threshold
    p3 = Packet(0, 2, 0)
    sw.ingress(p3)
    assert p3.ecn                             # persisted, not per-packet
    sw.drain(10)
    p4 = Packet(0, 3, 0)
    sw.ingress(p4)
    assert not p4.ecn                         # cleared after drain


@settings(max_examples=20, deadline=None)
@given(st.floats(0.05, 0.4), st.integers(0, 1000))
def test_higher_loss_more_retx(loss, seed):
    lo = run_flow(200, 0.0, seed=seed, w_max=16)
    hi = run_flow(200, loss, seed=seed, w_max=16)
    assert hi["retx"] >= lo["retx"]
    assert hi["duplicate_effects"] == {}


def test_state_is_w_max_bits_per_flow():
    sw = FlipBitSwitch(w_max=256)
    sw.register_flow(7)
    assert len(sw.bits[7]) == 256             # the paper's N x w_max bits


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 300), st.floats(0.0, 0.5), st.integers(0, 2**16),
       st.sampled_from([4, 16, 64]))
def test_run_flow_matches_reference(n_packets, loss, seed, w_max):
    """The same seeded flow through the JAX package's simulator: every
    counter of the result (sent, retx, drops, ECN, applied) agrees."""
    from repro.core.transport import run_flow as ref_run_flow
    got = run_flow(n_packets, loss, seed=seed, w_max=w_max)
    want = ref_run_flow(n_packets, loss, seed=seed, w_max=w_max)
    assert got == want

"""The real wire in the port: ``repro_torch.net`` and its launchers.

The ten tests of ``tests/test_wire.py`` against the port, with the
daemon's register file and the client's mirror on the CPU
(``device="cpu"``), at the same geometry: every addTo lands exactly once
under seeded loss, duplication and reordering, registers match an
in-process oracle element for element, and no call hangs past its
deadline.

Then the crossings with the JAX package, whose side is built inside each
test function (the card's machine has no JAX): both codecs give the same
bytes; a client of either package drives a daemon of the other through a
seeded fault proxy and leaves the registers the reference-on-reference
run leaves; a spool that either daemon writes restores in the other.

The port's own repairs: a daemon stopped and respawned from its spool
while a client keeps ops in flight lands every addTo once (the reference
spools before it closes its connections, so an op applied and ACKed in
between is lost); an op that raises in the daemon stops it visibly and
spools nothing; the kernel wrappers' counts stay exact when several
threads launch at once. ``launch/switchd.py`` and ``launch/elastic.py
--wire-quorum`` run as processes; ``elastic.run`` resumes from its
checkpoint and ``elastic.quorum_demo`` prints the reference's lines.

CUDA lane (marker ``cuda``, skipped without a card): the daemon's register
file on the card against the same traffic on a CPU daemon, bitwise, with
the kernel's launches counted.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.core.inc_map import SwitchMemory, to_jax_state
from repro_torch.kernels import ops
from repro_torch.net import (FaultProxy, FaultSpec, RemoteSwitchMemory,
                             SwitchServer, WireTransport)
from repro_torch.net import protocol as proto

GEO = dict(n_segments=4, seg_slots=256)
CPU = dict(device="cpu")
SRC = Path(__file__).resolve().parents[1] / "src"


def _stack(spec=None, **kw):
    """server [+ proxy] + transport + memory; returns (srv, px, t, mem)."""
    srv = SwitchServer(track_effects=True, **GEO, **CPU).start()
    px = FaultProxy(srv.address, spec).start() if spec else None
    addr = px.address if px else srv.address
    t = WireTransport(addr, flow_id=kw.pop("flow_id", 1), w_max=8,
                      rto_base=kw.pop("rto_base", 0.02),
                      call_timeout=kw.pop("call_timeout", 30.0), **kw)
    mem = RemoteSwitchMemory(t, **GEO, **CPU)
    return srv, px, t, mem


def _teardown(srv, px, t):
    t.close()
    if px:
        px.stop()
    srv.stop()
    assert srv.error is None


# -- exactly-once under chaos -------------------------------------------------

@settings(max_examples=5, deadline=None)
@given(st.floats(0.0, 0.2), st.integers(0, 2**16))
def test_exactly_once_under_chaos(loss, seed):
    """Any seeded loss/dup/reorder pattern: every addto lands exactly
    once, element-exact against local accumulation."""
    spec = FaultSpec(seed=seed, loss=loss, dup=loss / 2, reorder=loss / 2)
    srv, px, t, mem = _stack(spec)
    try:
        assert mem.reserve(1, 32)
        phys = np.arange(32, dtype=np.int64)
        expect = np.zeros(32, dtype=np.int64)
        rng = np.random.default_rng(seed)
        for _ in range(24):
            vals = rng.integers(-50, 50, size=32).astype(np.int32)
            mem.addto(phys, vals)
            expect += vals
        got = mem.get(phys).astype(np.int64)
        assert np.array_equal(got, expect)
        assert t.ctrl("stats")["duplicate_effects"] == {}
    finally:
        _teardown(srv, px, t)


def test_crash_restart_replay():
    """Daemon crash mid-stream: clients reconnect and replay; state
    survives; still exactly-once."""
    spec = FaultSpec(seed=3, loss=0.2, dup=0.1, reorder=0.1)
    srv, px, t, mem = _stack(spec)
    try:
        assert mem.reserve(1, 64)
        phys = np.arange(64, dtype=np.int64)
        expect = np.zeros(64, dtype=np.int64)
        rng = np.random.default_rng(7)
        for _ in range(30):
            vals = rng.integers(-50, 50, size=64).astype(np.int32)
            mem.addto(phys, vals)
            expect += vals
        srv.crash(0.3)                      # refuse service; state survives
        for _ in range(30):
            vals = rng.integers(-50, 50, size=64).astype(np.int32)
            mem.addto(phys, vals)
            expect += vals
        got = mem.get(phys).astype(np.int64)
        assert np.array_equal(got, expect)
        stats = t.ctrl("stats")
        assert stats["duplicate_effects"] == {}
        assert t.report()["reconnects"] >= 1
        assert not mem.fallback_active
    finally:
        _teardown(srv, px, t)


def test_oracle_equivalence_mixed_ops():
    """Mixed addto/addto_f32/clear stream under reorder+dup faults must
    match an in-process SwitchMemory oracle bit-for-bit (including the
    f32 quantization scale math)."""
    spec = FaultSpec(seed=5, loss=0.1, dup=0.15, reorder=0.15)
    srv, px, t, mem = _stack(spec)
    oracle = SwitchMemory(**GEO, **CPU)
    try:
        assert mem.reserve(2, 48) and oracle.reserve(2, 48)
        phys = np.arange(48, dtype=np.int64)
        rng = np.random.default_rng(11)
        scale = 1 << 16
        for i in range(20):
            kind = rng.integers(0, 10)
            if kind < 5:
                vals = rng.integers(-99, 99, size=48).astype(np.int32)
                mem.addto(phys, vals)
                oracle.addto(phys, vals)
            elif kind < 9:
                fvals = rng.standard_normal(48).astype(np.float32)
                mem.addto_f32(phys, fvals, scale)
                oracle.addto_f32(phys, fvals, scale)
            else:
                mem.clear(phys[:16])
                oracle.clear(phys[:16])
        assert np.array_equal(mem.get(phys), oracle.get(phys))
        wire_f, _ = mem.read_f32(phys, scale)
        orac_f, _ = oracle.read_f32(phys, scale)
        assert isinstance(wire_f, torch.Tensor) and wire_f.device.type == "cpu"
        assert torch.equal(wire_f, orac_f)
        assert t.ctrl("stats")["duplicate_effects"] == {}
    finally:
        _teardown(srv, px, t)


def test_reserve_mirrors_daemon_placement():
    """Two clients reserving in opposite order still agree on physical
    placement: the daemon's FCFS start is authoritative."""
    srv = SwitchServer(track_effects=True, **GEO, **CPU).start()
    t1 = WireTransport(srv.address, flow_id=1, w_max=8)
    t2 = WireTransport(srv.address, flow_id=2, w_max=8)
    m1 = RemoteSwitchMemory(t1, **GEO, **CPU)
    m2 = RemoteSwitchMemory(t2, **GEO, **CPU)
    try:
        assert m1.reserve(10, 20) and m1.reserve(11, 30)
        assert m2.reserve(11, 30) and m2.reserve(10, 20)
        assert m1.partitions == m2.partitions
        # and a write through one client is visible through the other
        start = m1.partitions[10][0]
        phys = start + np.arange(20, dtype=np.int64)
        m1.addto(phys, np.full(20, 7, np.int32))
        t1.barrier()                         # m2's read fences only flow 2
        assert np.array_equal(m2.get(phys), np.full(20, 7, np.int32))
    finally:
        t1.close()
        t2.close()
        srv.stop()


# -- failure semantics --------------------------------------------------------

def test_deadline_never_hangs():
    """An op against a daemon that stays down raises TimeoutError at
    (about) the call deadline — never a hang, never silence."""
    srv, px, t, mem = _stack(call_timeout=0.6, unreachable_after=30.0)
    try:
        assert mem.reserve(1, 8)
        phys = np.arange(8, dtype=np.int64)
        srv.crash(10.0)                      # much longer than the deadline
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            mem.get(phys)                    # barrier or read must trip
        took = time.monotonic() - t0
        assert took < 5.0                    # bounded, not hung
    finally:
        _teardown(srv, px, t)


def test_degrades_to_local_plane():
    """Past unreachable_after the transport degrades and the memory
    falls back to its host-side plane: ops keep working locally and the
    report says so."""
    srv, px, t, mem = _stack(call_timeout=2.0, unreachable_after=0.3)
    try:
        assert mem.reserve(1, 16)
        phys = np.arange(16, dtype=np.int64)
        mem.addto(phys, np.ones(16, np.int32))
        assert np.array_equal(mem.get(phys), np.ones(16, np.int32))
        srv.crash(30.0)
        deadline = time.monotonic() + 10.0
        while not t.degraded and time.monotonic() < deadline:
            try:
                mem.addto(phys, np.ones(16, np.int32))
            except TimeoutError:
                pass
            time.sleep(0.05)
        assert t.degraded
        mem.addto(phys, np.ones(16, np.int32))   # served by the fallback
        assert mem.fallback_active
        rep = mem.report()
        assert rep["degraded"] and rep["fallback_active"]
        assert rep["fallback_activations"] >= 1
        assert len(mem.get(phys)) == 16          # local reads still work
    finally:
        _teardown(srv, px, t)


def test_close_fails_pending_ops():
    srv, px, t, mem = _stack()
    assert mem.reserve(1, 8)
    _teardown(srv, px, t)
    with pytest.raises((TimeoutError, ConnectionError)):
        t.call(proto.OP_READ, {}, [np.arange(8, dtype=np.int64)])


# -- runtime integration ------------------------------------------------------

@pytest.fixture
def wire_runtime():
    import repro_torch.api as inc
    from repro_torch.core.channel import Controller

    srv = SwitchServer(track_effects=True, **GEO, **CPU).start()
    t = WireTransport(srv.address, flow_id=1, w_max=8)
    sw = RemoteSwitchMemory(t, **GEO, **CPU)
    rt = inc.IncRuntime(controller=Controller(switch=sw))
    yield rt, t, srv
    rt.close()
    t.close()
    srv.stop()


def test_runtime_typed_stubs_over_wire(wire_runtime):
    """The whole point of the plug-in seam: typed stubs work unchanged
    when the switch plane lives in another process, and the snapshot
    exports (and validates) a 'wire' section."""
    import repro_torch.api as inc
    from repro_torch.obs import schema as obs_schema

    rt, t, srv = wire_runtime

    @inc.service(app="WIRE-T")
    class WireProbe:
        @inc.rpc(request_msg="R")
        def Push(self, kvs: inc.Agg[inc.STRINTMap],
                 payload: inc.Plain) -> {"payload": inc.Plain}: ...

        @inc.rpc(reply_msg="Q")
        def Query(self, kvs: inc.ReadMostly[inc.STRINTMap]): ...

    rt.server.register("Push", lambda req: {"payload": "ack"})
    stub = rt.make_stub(WireProbe, n_slots=128)
    truth = {}
    for i in range(24):
        kvs = {f"k-{(i * 5 + j) % 9}": j + 1 for j in range(3)}
        for k, v in kvs.items():
            truth[k] = truth.get(k, 0) + v
        assert stub.Push(kvs=kvs, payload=f"p{i}").result()
    rt.drain()
    q = stub.Query(kvs={k: 0 for k in truth}).result()
    assert q["kvs"] == truth                 # aggregated in the daemon
    report = rt.scheduling_report()
    assert report["__wire__"]["connected"]
    snap = rt.metrics_snapshot()
    assert snap["wire"]["acked"] >= 1
    assert snap["wire"]["fallback_active"] is False
    obs_schema.validate(snap,
                        obs_schema.load(obs_schema.repo_schema_path()))


# -- codec properties (pure, no sockets) --------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 2000),
       st.integers(0, 2**16))
def test_op_codec_roundtrip(seq, n, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32),
              rng.standard_normal(n).astype(np.float32)]
    meta = {"scale": 65536.0, "seq": seq}
    blob = proto.encode_op("addto_f32", meta, arrays)
    op2, meta2, arrays2 = proto.decode_op(blob)
    assert op2 == "addto_f32" and meta2 == meta
    for a, b in zip(arrays, arrays2):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 5000), st.integers(64, 512), st.integers(0, 2**16))
def test_fragmentation_roundtrip(nbytes, mtu, seed):
    rng = np.random.default_rng(seed)
    blob = rng.bytes(nbytes)
    frags = proto.fragment(blob, mtu)
    assert all(len(f) <= mtu for f in frags)
    re = proto.Reassembler()
    out = None
    for i, f in enumerate(frags):
        out = re.add(7, 3, i, len(frags), f)
    assert out == blob


# -- crossings with the JAX package -------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 3000),
       st.integers(64, 4096), st.integers(0, 2**16))
def test_codec_bytes_match_reference(seq, n, mtu, seed):
    """``encode_op`` and every frame builder give the reference's bytes,
    and each package decodes the other's."""
    from repro.net import protocol as ref
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 2**20, size=n).astype(np.int64),
              rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32),
              rng.standard_normal(n).astype(np.float32)]
    meta = {"scale": 1e8, "dense": [seq % 1000, n]}
    blob = proto.encode_op(proto.OP_ADDTO_F32, meta, arrays)
    assert blob == ref.encode_op(ref.OP_ADDTO_F32, meta, arrays)
    flip = seq & 1
    assert proto.op_frames(3, seq, flip, blob, mtu) == \
        ref.op_frames(3, seq, flip, blob, mtu)
    assert proto.ack_frames(3, seq, True, False, blob, mtu) == \
        ref.ack_frames(3, seq, True, False, blob, mtu)
    assert proto.hello_frame(5, 8) == ref.hello_frame(5, 8)
    assert proto.ctrl_frame({"cmd": "stats"}) == \
        ref.ctrl_frame({"cmd": "stats"})
    for dec, enc in ((proto.decode_op, ref.encode_op),
                     (ref.decode_op, proto.encode_op)):
        op, meta2, arrays2 = dec(enc("read", meta, arrays))
        assert op == "read" and meta2 == meta
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(arrays, arrays2))


def _package(name: str):
    """(net module, SwitchMemory kwargs of a daemon or a client mirror) of
    the port ("torch") or the reference ("jax", imported only here)."""
    if name == "jax":
        import repro.net as ref_net
        return ref_net, {}
    import repro_torch.net as port_net
    return port_net, CPU


def _mixed_stream(seed: int, n: int = 48, ops_n: int = 30):
    """A seeded stream of addto (dense and scattered with duplicate
    slots), addto_f32, read and clear over slots [0, n)."""
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(ops_n):
        kind = int(rng.integers(0, 12))
        if kind < 3:
            stream.append(("addto", np.arange(n, dtype=np.int64),
                           rng.integers(-99, 99, n).astype(np.int32)))
        elif kind < 5:
            stream.append(("addto", rng.integers(0, n, n).astype(np.int64),
                           rng.integers(-99, 99, n).astype(np.int32)))
        elif kind < 8:
            stream.append(("addto_f32", np.arange(n, dtype=np.int64),
                           rng.standard_normal(n).astype(np.float32)))
        elif kind < 10:
            stream.append(("read", np.arange(n, dtype=np.int64), None))
        else:
            lo = int(rng.integers(0, n - 8))
            stream.append(("clear", np.arange(lo, lo + 8, dtype=np.int64),
                           None))
    return stream


def _regs(srv) -> np.ndarray:
    """A daemon's register file (either package) as one numpy array."""
    state = srv.switch.state_dict()
    if isinstance(state["regs"][0], torch.Tensor):
        state = to_jax_state(state)
    return np.concatenate([np.asarray(r) for r in state["regs"]])


def _drive(client: str, server: str, stream, seed: int,
           server_kw: dict | None = None):
    """The stream from a ``client`` package's transport to a ``server``
    package's daemon through a seeded fault proxy; returns (each read's
    registers, the daemon's register file)."""
    cnet, ckw = _package(client)
    snet, skw = _package(server)
    srv = snet.SwitchServer(track_effects=True, **GEO,
                            **(server_kw or skw)).start()
    px = snet.FaultProxy(srv.address, snet.FaultSpec(
        seed=seed, loss=0.1, dup=0.05, reorder=0.05)).start()
    t = cnet.WireTransport(px.address, flow_id=1, w_max=8, rto_base=0.02,
                           call_timeout=30.0)
    mem = cnet.RemoteSwitchMemory(t, **GEO, **ckw)
    reads = []
    try:
        assert mem.reserve(1, 48)
        for op, phys, vals in stream:
            if op == "addto":
                mem.addto(phys, vals)
            elif op == "addto_f32":
                mem.addto_f32(phys, vals, 10 ** 6)
            elif op == "read":
                reads.append(np.asarray(mem.get(phys)))
            else:
                mem.clear(phys)
        reads.append(np.asarray(mem.get(np.arange(48, dtype=np.int64))))
        assert t.ctrl("stats")["duplicate_effects"] == {}
        assert not mem.fallback_active
    finally:
        t.close()
        px.stop()
        srv.stop()
    assert getattr(srv, "error", None) is None
    return reads, _regs(srv)


@pytest.mark.parametrize("client,server", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_cross_package_client_and_daemon(client, server):
    """Either package's client drives either package's daemon: the same
    seeded mixed stream under a seeded fault proxy leaves every read and
    the register file equal, element for element, to the run of the
    reference's client against the reference's daemon."""
    stream = _mixed_stream(21)
    want_reads, want_regs = _drive("jax", "jax", stream, 9)
    got_reads, got_regs = _drive(client, server, stream, 9)
    assert len(got_reads) == len(want_reads)
    for a, b in zip(got_reads, want_reads):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got_regs, want_regs)


@pytest.mark.parametrize("first,second", [("torch", "jax"), ("jax", "torch")])
def test_spool_crosses_packages(first, second, tmp_path):
    """A daemon of ``first`` writes its spool on stop; a daemon of
    ``second`` restores it at the same address, and the same client flow
    carries on: registers, partitions and slot seqs survive, and every
    addTo lands once."""
    uds, spool = str(tmp_path / "sw.sock"), str(tmp_path / "sw.pkl")
    stream = _mixed_stream(33)
    half = len(stream) // 2

    def daemon(pkg):
        net, kw = _package(pkg)
        return net.SwitchServer(uds_path=uds, state_spool=spool,
                                track_effects=True, **GEO, **kw).start()

    t = WireTransport(uds, flow_id=4, w_max=8, rto_base=0.02,
                      reconnect_backoff=0.01, call_timeout=30.0)
    mem = RemoteSwitchMemory(t, **GEO, **CPU)
    oracle = SwitchMemory(**GEO, **CPU)
    srv = daemon(first)
    try:
        assert mem.reserve(1, 48) and oracle.reserve(1, 48)
        for i, (op, phys, vals) in enumerate(stream):
            if i == half:
                t.barrier()
                seqs = {f: list(s) for f, s in srv.slot_seq.items()}
                srv.stop()                      # spools
                assert os.path.exists(spool)
                srv = daemon(second)
                assert srv.slot_seq == seqs
                assert srv.switch.partitions == oracle.partitions
                assert np.array_equal(_regs(srv), np.concatenate(
                    [np.asarray(r) for r in
                     to_jax_state(oracle.state_dict())["regs"]]))
            if op == "addto":
                mem.addto(phys, vals)
                oracle.addto(phys, vals)
            elif op == "addto_f32":
                mem.addto_f32(phys, vals, 10 ** 6)
                oracle.addto_f32(phys, vals, 10 ** 6)
            elif op == "read":
                assert np.array_equal(mem.get(phys), oracle.get(phys))
            else:
                mem.clear(phys)
                oracle.clear(phys)
        t.barrier()
        want = to_jax_state(oracle.state_dict())["regs"]
        assert np.array_equal(_regs(srv), np.concatenate(want))
        assert not mem.fallback_active
    finally:
        t.close()
        srv.stop(spool=False)


# -- the port's repairs -------------------------------------------------------

RESTARTS = 4


def test_restart_mid_stream_lands_every_addto_once(tmp_path):
    """The restart-spool repair: a client streams addTos while the daemon
    is stopped (spool on) and respawned from its spool, again and again,
    with ops in flight each time. The reference's ``stop`` spools before
    it closes the connections, so an op applied and ACKed in between is
    missing after the respawn; here every addTo lands exactly once."""
    uds, spool = str(tmp_path / "sw.sock"), str(tmp_path / "sw.pkl")

    def daemon():
        return SwitchServer(uds_path=uds, state_spool=spool,
                            track_effects=True, **GEO, **CPU).start()

    srv = daemon()
    t = WireTransport(uds, flow_id=1, w_max=8, rto_base=0.02,
                      reconnect_backoff=0.005, call_timeout=30.0)
    mem = RemoteSwitchMemory(t, **GEO, **CPU)
    restarts, errors = [], []

    def restart_loop():
        nonlocal srv
        try:
            for _ in range(RESTARTS):
                acked = t.report()["acked"]
                deadline = time.monotonic() + 20
                while (t.report()["acked"] < acked + 60
                       and time.monotonic() < deadline):
                    time.sleep(0.002)
                in_flight = t.report()["in_flight"]
                srv.stop()
                restarts.append(in_flight)
                srv = daemon()
        except Exception as exc:    # noqa: BLE001 -- reported below
            errors.append(exc)

    try:
        assert mem.reserve(1, 64)
        phys = np.arange(64, dtype=np.int64)
        expect = np.zeros(64, dtype=np.int64)
        rng = np.random.default_rng(5)
        restarter = threading.Thread(target=restart_loop)
        restarter.start()
        while restarter.is_alive():
            vals = rng.integers(-50, 50, size=64).astype(np.int32)
            mem.addto(phys, vals)
            expect += vals
        restarter.join(timeout=60)
        assert not restarter.is_alive() and errors == []
        assert len(restarts) == RESTARTS
        got = mem.get(phys).astype(np.int64)
        np.testing.assert_array_equal(got, expect)
        assert not mem.fallback_active and not t.degraded
        assert t.report()["reconnects"] >= RESTARTS
    finally:
        t.close()
        srv.stop(spool=False)
    assert srv.error is None


def test_failed_apply_stops_the_daemon(tmp_path):
    """An op that raises in the daemon (a kernel wrapper's RuntimeError)
    is fatal and visible: the error is recorded, the daemon stops, sends
    no ACK for the op and writes no spool (the op's seq was recorded, its
    effect not)."""
    spool = str(tmp_path / "sw.pkl")
    srv = SwitchServer(track_effects=True, state_spool=spool, **GEO,
                       **CPU).start()

    def broken(phys, vals):
        raise RuntimeError("repro_sparse_addto kernel launch failed")

    t = WireTransport(srv.address, flow_id=1, w_max=8, rto_base=0.02,
                      call_timeout=2.0, unreachable_after=30.0)
    mem = RemoteSwitchMemory(t, **GEO, **CPU)
    try:
        assert mem.reserve(1, 8)
        srv.switch.addto = broken
        mem.addto(np.array([0, 3], np.int64), np.array([1, 2], np.int32))
        with pytest.raises(TimeoutError):
            t.barrier(timeout=2.0)              # never ACKed
        assert srv.error is not None
        assert "kernel launch failed" in srv.error
        assert srv.stats["effects_applied"] == 0
        deadline = time.monotonic() + 10
        while srv._accept_thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._accept_thread.is_alive()    # stopped serving
        assert not os.path.exists(spool)
    finally:
        t.close()
        srv.stop()


def test_launch_counts_exact_across_threads():
    """The kernel wrappers count from the daemon's handler threads: 16
    threads calling one wrapper with the interpreter switching threads as
    often as it can lose no count."""
    n_threads, calls = 16, 200
    before = ops.plain_counts()["sparse_addto"]
    regs = [torch.zeros(8, dtype=torch.int32) for _ in range(n_threads)]
    idx = np.array([1, 5], np.int32)
    val = np.array([1, 1], np.int32)
    errors = []

    def hammer(r):
        try:
            for _ in range(calls):
                ops.sparse_addto(r, idx, val)
        except Exception as exc:    # noqa: BLE001 -- reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(r,)) for r in regs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and errors == []
    assert ops.plain_counts()["sparse_addto"] - before == n_threads * calls
    assert all(int(r[1]) == calls and int(r[5]) == calls for r in regs)


# -- the launchers as processes -----------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_switchd_process_spools_on_sigterm(tmp_path):
    """``python -m repro_torch.launch.switchd --device cpu``: READY names
    the device; SIGTERM stops it with rc 0, STOPPED, and a spool the JAX
    package's ``SwitchMemory`` loads."""
    from repro.core.inc_map import SwitchMemory as RefSwitch
    uds, spool = str(tmp_path / "d.sock"), str(tmp_path / "d.pkl")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.switchd", "--uds", uds,
         "--segments", "4", "--slots", "256", "--state-spool", spool,
         "--device", "cpu"], stdout=subprocess.PIPE, text=True, env=_env())
    try:
        line = p.stdout.readline()
        assert line.startswith("SWITCHD READY")
        assert json.loads(line.split("READY", 1)[1]) == {"uds": uds,
                                                         "device": "cpu"}
        t = WireTransport(uds, flow_id=2, w_max=8)
        mem = RemoteSwitchMemory(t, **GEO, **CPU)
        try:
            assert mem.reserve(7, 300)
            mem.addto(np.arange(250, 300, dtype=np.int64),
                      np.arange(50, dtype=np.int32))
            t.barrier()
        finally:
            t.close()
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0
    assert "SWITCHD STOPPED" in out
    import pickle
    with open(spool, "rb") as fh:
        state = pickle.load(fh)
    ref = RefSwitch(**GEO)
    ref.load_state(state)
    assert ref.partitions == {7: (0, 300)}
    assert np.array_equal(ref.get(np.arange(250, 300)),
                          np.arange(50, dtype=np.int32))


# a daemon whose segments hold tensors, as on the card (on the CPU they are
# numpy), fed ops of several fragments (a small MTU), which reassemble into
# bytes and decode to read-only arrays; in a process of its own, since
# PyTorch warns of such an array once a process
_READ_ONLY_ROUND_TRIP = """
import warnings
import numpy as np, torch
from repro_torch.net import RemoteSwitchMemory, SwitchServer, WireTransport
warnings.simplefilter("error")
geo = dict(n_segments=4, seg_slots=256)
srv = SwitchServer(device="cpu", **geo).start()
for seg in srv.switch.segments:
    seg.regs = torch.from_numpy(seg.regs.copy())
t = WireTransport(srv.address, flow_id=1, w_max=8, mtu=128,
                  call_timeout=20.0)
mem = RemoteSwitchMemory(t, device="cpu", **geo)
try:
    dense = np.arange(200, 300, dtype=np.int64)
    mem.addto(dense, np.arange(100, dtype=np.int32))
    mem.addto(dense[::3], np.full(34, 5, np.int32))
    got = mem.get(dense)
finally:
    t.close()
    srv.stop()
assert srv.error is None, srv.error
want = np.arange(100, dtype=np.int32)
want[::3] += 5
assert np.array_equal(got, want), got
print("round trip exact")
"""


def test_wire_round_trip_hands_torch_no_read_only_array():
    """An op of several frames decodes to read-only views of its
    reassembled bytes; where the daemon's segments are tensors (on the
    card), the kernel wrappers take them in. A dense and a scattered addTo
    and a read over the wire, with every warning an error, in a fresh
    process: a read-only array wrapped by ``torch.from_numpy`` raises
    there and stops the daemon."""
    p = subprocess.run([sys.executable, "-c", _READ_ONLY_ROUND_TRIP],
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "round trip exact" in p.stdout


def test_launchers_raise_without_a_card():
    """No silent CPU fallback: without ``--device cpu`` the daemon and the
    wire-quorum demo ask for the card and fail where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for mod, extra in (("repro_torch.launch.switchd", []),
                       ("repro_torch.launch.elastic", ["--wire-quorum"])):
        p = subprocess.run([sys.executable, "-m", mod, *extra], env=_env(),
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0
        assert "device='cpu'" in p.stderr


def test_elastic_wire_quorum_process():
    """``python -m repro_torch.launch.elastic --wire-quorum --wire-loss
    0.05 --device cpu``: a daemon and two worker processes over a lossy
    proxy, the daemon SIGTERM'd and respawned from its spool mid-run.
    Every vote and gradient lands once (the reference's run of this
    command loses a worker's ops across the restart)."""
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.elastic", "--wire-quorum",
         "--wire-loss", "0.05", "--device", "cpu"], env=_env(),
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "switch daemon restarted mid-run" in p.stdout
    line = [ln for ln in p.stdout.splitlines()
            if ln.startswith("wire quorum:")][-1]
    assert "votes=[2, 2, 2, 2, 2, 2] exact=True/True committed=6/6 " \
        "dupes={}" in line


def test_elastic_run_resumes_from_checkpoint(tmp_path):
    """``elastic.run``: the reduced model trains to the "preemption",
    restarts from its checkpoint and runs only the steps not yet applied,
    on the CPU."""
    from repro_torch.launch import elastic
    out = elastic.run("qwen2.5-3b", 6, 3, str(tmp_path / "ckpt"),
                      device="cpu")
    assert len(out["phase1"]) == 3 and len(out["phase2"]) == 3
    assert np.all(np.isfinite(out["phase1"] + out["phase2"]))


def test_quorum_demo_matches_reference(capsys):
    """``elastic.quorum_demo`` on a gloo group of one rank prints the
    reference's lines (one JAX CPU device): the count, the commit and the
    elastic mean of each round."""
    from repro.launch import elastic as ref_elastic
    from repro_torch.launch import elastic
    rows = elastic.quorum_demo(device="cpu")
    got = capsys.readouterr().out.splitlines()
    ref_elastic.quorum_demo()
    want = capsys.readouterr().out.splitlines()
    assert rows == [(1, 1, True, 1.0)] * 3
    assert got == want


# -- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the daemon's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_daemon_matches_cpu(cuda):
    """The port's client against a port daemon whose register file is on
    the card, then against one on the CPU, the same seeded stream through
    the same seeded proxy: every read and the register file bitwise equal,
    and the card's daemon launched sparse_addto."""
    stream = _mixed_stream(21)
    want_reads, want_regs = _drive("torch", "torch", stream, 9)
    ops.reset_counts()
    got_reads, got_regs = _drive("torch", "torch", stream, 9,
                                 server_kw={"device": None})
    torch.cuda.synchronize()
    assert ops.launch_counts()["sparse_addto"] > 0
    assert ops.plain_counts()["sparse_addto"] == 0
    for a, b in zip(got_reads, want_reads):
        assert np.array_equal(a, b)
    assert np.array_equal(got_regs, want_regs)

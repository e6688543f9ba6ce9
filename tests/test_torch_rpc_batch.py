"""Batch-vs-sequential equivalence of the port's RPC data plane.

Mirrors the 13 tests of ``tests/test_rpc_batch.py`` on the port, every
runtime on ``device="cpu"``. The single-pipeline invariant of
core/rpc.py:

    stub.call_batch(method, reqs) == [stub.call(method, r) for r in reqs]

is checked per NetFilter feature (Stream.modify, Map.addTo, CntFwd quorum
ordering, Map.get + clear policies) by running the same request stream
through a batched runtime and an independently-built sequential runtime
and comparing positional replies AND final observable map state; where a
test compares a stream, the port's sequential replies must also equal the
JAX package's on the same stream.

The device lane is added on top: a typed ``Agg[FPArray](device=True)``
service whose partition spans 7 register segments, so every flush of the
batched pipeline is a multi-segment transmit (one plain call of
``fused_addto`` a flush, where a call per segment would be 7). Batch and
sequential runs must agree bit for bit, and both with the JAX package.
"""
import numpy as np
import pytest
import torch

import repro_torch.api as tinc
from repro_torch.core.channel import Controller as TController
from repro_torch.core.inc_map import SwitchMemory as TSwitch
from repro_torch.core.netfilter import NetFilter
from repro_torch.core.rpc import Field, Service
from repro_torch.core.rpc import NetRPC as _NetRPC
from repro_torch.kernels import ops


def NetRPC():
    return _NetRPC(device="cpu")


def nf(d):
    return NetFilter.from_dict(d)


def _plain(x):
    """A reply as plain Python values (tensors and arrays as lists)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if hasattr(x, "__array__") and not np.isscalar(x):
        return np.asarray(x).tolist()
    return x


def _jax_sequential(make_svc, reqs, handlers):
    """The JAX package's sequential replies to the same stream;
    ``make_svc`` builds the service from (NetFilter, Field, Service)."""
    from repro.core.netfilter import NetFilter as JNetFilter
    from repro.core.rpc import Field as JField
    from repro.core.rpc import NetRPC as JNetRPC
    from repro.core.rpc import Service as JService
    rt = JNetRPC()
    for m, fn in handlers:
        rt.server.register(m, fn)
    stub = rt.make_stub(make_svc(JNetFilter.from_dict, JField, JService))
    return [stub.call(m, r) for m, r in reqs]


def monitor_service(nf=nf, Field=Field, Service=Service):
    svc = Service("Monitor")
    svc.rpc("Push", [Field("kvs", "STRINTMap"), Field("payload")],
            [Field("payload")],
            nf({"AppName": "MON", "addTo": "R.kvs"}))
    svc.rpc("Query", [Field("kvs", "STRINTMap")], [Field("kvs", "STRINTMap")],
            nf({"AppName": "MON", "get": "Y.kvs"}))
    return svc


def run_sequential(svc, reqs, handlers=()):
    rt = NetRPC()
    for m, fn in handlers:
        rt.server.register(m, fn)
    stub = rt.make_stub(svc)
    return [stub.call(m, r) for m, r in reqs], stub


def run_batched(svc, reqs, handlers=()):
    """Same stream via submit()/drain(): one coalesced batch per channel."""
    rt = NetRPC()
    for m, fn in handlers:
        rt.server.register(m, fn)
    stub = rt.make_stub(svc)
    tickets = [rt.submit(stub, m, r) for m, r in reqs]
    rt.drain()
    return [t.result() for t in tickets], stub


def assert_equiv(make_svc, reqs, handlers=(), probe_keys=()):
    seq, seq_stub = run_sequential(make_svc(), reqs, handlers)
    bat, bat_stub = run_batched(make_svc(), reqs, handlers)
    assert bat == seq
    # final observable map state must agree too
    method = reqs[0][0]
    for k in probe_keys:
        assert (bat_stub.agents[method].read(k)
                == seq_stub.agents[method].read(k)), k
    assert _plain(seq) == _plain(_jax_sequential(make_svc, reqs, handlers))
    return seq


# ---- Map.addTo --------------------------------------------------------------

def test_addto_batch_equals_sequential():
    rng = np.random.RandomState(0)
    reqs = [("Push", {"kvs": {f"flow-{int(f)}": 1 for f in
                              rng.zipf(1.4, 16) % 50},
                      "payload": "p"}) for _ in range(40)]
    keys = [f"flow-{i}" for i in range(50)]
    assert_equiv(monitor_service, reqs,
                 handlers=[("Push", lambda r: {"payload": "ok"})],
                 probe_keys=keys)


def test_call_batch_is_call_for_n1():
    svc = monitor_service()
    rt = NetRPC()
    stub = rt.make_stub(svc)
    assert stub.call_batch("Push", [{"kvs": {"a": 2}}]) == \
        [stub.call("Push", {"kvs": {"a": 3}})]  # both {} replies
    assert stub.agents["Push"].read("a") == 5


# ---- Stream.modify ----------------------------------------------------------

def _modify_service(nf=nf, Field=Field, Service=Service):
    svc = Service("Mod")
    svc.rpc("Push", [Field("kvs", "STRINTMap")], [Field("msg")],
            nf({"AppName": "MOD", "addTo": "R.kvs", "Precision": 2,
                "modify": {"op": "max", "para": 700}}))
    svc.rpc("Shift", [Field("kvs", "STRINTMap")], [Field("msg")],
            nf({"AppName": "MOD", "addTo": "R.kvs",
                "modify": {"op": "shiftl", "para": 2}}))
    return svc


def test_modify_batch_equals_sequential():
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(24):
        m = "Push" if i % 3 else "Shift"     # mixed (op, para) groups
        reqs.append((m, {"kvs": {f"k{j}": int(v) for j, v in
                                 enumerate(rng.randint(0, 50, 4))}}))
    assert_equiv(_modify_service, reqs, probe_keys=[f"k{j}" for j in range(4)])


# ---- CntFwd quorum ordering -------------------------------------------------

def _vote_service(nf=nf, Field=Field, Service=Service):
    svc = Service("Vote")
    svc.rpc("Cast", [Field("kvs", "STRINTMap")], [Field("msg")],
            nf({"AppName": "VOTE",
                "CntFwd": {"to": "SRC", "threshold": 3, "key": "R.kvs"}}))
    return svc


def test_cntfwd_quorum_ordering_batch_equals_sequential():
    hits = []
    handlers = [("Cast", lambda r: hits.append(1) or {"msg": "committed"})]
    # two interleaved ballots (the kvs key is the ballot id); exactly the
    # 3rd vote of each forwards
    reqs = [("Cast", {"kvs": {b: 1}})
            for b in ("b1", "b2", "b1", "b1", "b2", "b1", "b2", "b2")]
    seq = assert_equiv(_vote_service, reqs, handlers=handlers)
    committed = [i for i, r in enumerate(seq) if r]
    assert committed == [3, 6]        # 3rd b1 is reqs[3], 3rd b2 is reqs[6]
    assert len(hits) == 6             # 2 per runtime (seq, batched, JAX)


def _requorum_service(nf=nf, Field=Field, Service=Service):
    svc = Service("Vote")
    svc.rpc("Cast", [Field("kvs", "STRINTMap")], [Field("msg")],
            nf({"AppName": "VOTE", "clear": "copy",
                "CntFwd": {"to": "SRC", "threshold": 2, "key": "ballot"}}))
    return svc


def test_cntfwd_with_clear_requorums_within_one_batch():
    handlers = [("Cast", lambda r: {"msg": "c"})]
    # clear resets the counter at quorum: votes 2 and 4 both commit
    reqs = [("Cast", {"kvs": {"b": 1}})] * 5
    seq = assert_equiv(_requorum_service, reqs, handlers=handlers)
    assert [bool(r) for r in seq] == [False, True, False, True, False]


# ---- Map.get + clear policies ----------------------------------------------

def _gradient_service(nf=nf, Field=Field, Service=Service):
    svc = Service("Gradient")
    svc.rpc("Update", [Field("tensor", "FPArray")], [Field("tensor",
                                                           "FPArray")],
            nf({"AppName": "DT", "Precision": 4,
                "get": "A.tensor", "addTo": "N.tensor", "clear": "copy",
                "CntFwd": {"to": "ALL", "threshold": 2, "key": "CID"}}))
    return svc


def test_syncagtr_get_clear_batch_equals_sequential():
    rng = np.random.RandomState(2)
    # two aggregation rounds: clear=copy must empty the map between them
    reqs = [("Update", {"tensor": rng.randn(8)}) for _ in range(4)]
    seq = assert_equiv(_gradient_service, reqs, probe_keys=list(range(8)))
    assert seq[0] == {} and seq[2] == {}
    want1 = reqs[0][1]["tensor"] + reqs[1][1]["tensor"]
    want2 = reqs[2][1]["tensor"] + reqs[3][1]["tensor"]
    got1 = np.array([seq[1]["tensor"][i] for i in range(8)])
    got2 = np.array([seq[3]["tensor"][i] for i in range(8)])
    np.testing.assert_allclose(got1, want1, atol=1e-3)
    np.testing.assert_allclose(got2, want2, atol=1e-3)


def _query_clear_service(nf=nf, Field=Field, Service=Service):
    svc = monitor_service(nf, Field, Service)
    svc.rpc("QueryClear", [Field("kvs", "STRINTMap")],
            [Field("kvs", "STRINTMap")],
            nf({"AppName": "MON", "get": "Y.kvs", "clear": "copy"}))
    return svc


def test_get_clear_interleaved_with_addto_in_batch():
    reqs = [
        ("Push", {"kvs": {"a": 5, "b": 1}}),
        ("Query", {"kvs": {"a": 0, "b": 0}}),       # sees 5, 1
        ("Push", {"kvs": {"a": 2}}),
        ("QueryClear", {"kvs": {"a": 0, "b": 0}}),  # sees 7, 1; clears
        ("Push", {"kvs": {"b": 3}}),
        ("Query", {"kvs": {"a": 0, "b": 0}}),       # sees 0, 3
    ]
    seq = assert_equiv(_query_clear_service, reqs, probe_keys=["a", "b"])
    assert seq[1]["kvs"] == {"a": 5, "b": 1}
    assert seq[3]["kvs"] == {"a": 7, "b": 1}
    assert seq[5]["kvs"] == {"a": 0, "b": 3}


# ---- cross-app / shared-channel coalescing ---------------------------------

def test_shared_channel_cross_stub_interleaving():
    """Two stubs (apps' clients) + two methods of one AppName interleaved in
    one drain: the channel queue preserves submission order across stubs."""
    svc = monitor_service()
    rt = NetRPC()
    s1, s2 = rt.make_stub(svc), rt.make_stub(svc)
    t = [rt.submit(s1, "Push", {"kvs": {"x": 1}}),
         rt.submit(s2, "Push", {"kvs": {"x": 2}}),
         rt.submit(s1, "Query", {"kvs": {"x": 0}}),
         rt.submit(s2, "Push", {"kvs": {"x": 4}}),
         rt.submit(s1, "Query", {"kvs": {"x": 0}})]
    assert all(not x.done for x in t)
    ch = s1.channels["Push"]
    assert ch is s2.channels["Push"] is s1.channels["Query"]  # one channel
    assert rt.drain() == 5
    assert t[2].result()["kvs"] == {"x": 3}
    assert t[4].result()["kvs"] == {"x": 7}
    assert ch.stats.batches == 1 and ch.stats.max_batch == 5
    # sequential oracle on a fresh runtime
    seq, _ = run_sequential(svc, [("Push", {"kvs": {"x": 1}}),
                                  ("Push", {"kvs": {"x": 2}}),
                                  ("Query", {"kvs": {"x": 0}}),
                                  ("Push", {"kvs": {"x": 4}}),
                                  ("Query", {"kvs": {"x": 0}})])
    assert [x.result() for x in t] == seq


def test_drain_separates_unrelated_channels():
    svc_a = monitor_service()
    svc_b = Service("Vote")
    svc_b.rpc("Cast", [Field("kvs", "STRINTMap")], [Field("msg")],
              nf({"AppName": "VOTE",
                  "CntFwd": {"to": "SRC", "threshold": 1, "key": "b"}}))
    rt = NetRPC()
    sa, sb = rt.make_stub(svc_a), rt.make_stub(svc_b)
    ta = rt.submit(sa, "Push", {"kvs": {"k": 1}})
    tb = rt.submit(sb, "Cast", {"kvs": {"b0": 1}})
    assert rt.drain() == 2
    assert ta.result() == {} and tb.result() == {}
    assert sa.channels["Push"].stats.batches == 1
    assert sb.channels["Cast"].stats.batches == 1
    assert sa.channels["Push"].gaid != sb.channels["Cast"].gaid


def test_handler_exception_mid_batch_keeps_earlier_effects():
    """Sequential semantics on the error path: calls that took their turn
    before a failing handler keep their INC side effects and resolve; the
    exception propagates; the failing call's ticket stays unresolved."""
    svc = monitor_service()
    rt = NetRPC()
    boom = RuntimeError("handler down")

    def handler(req):
        if req.get("payload") == "bad":
            raise boom
        return {"payload": "ok"}
    rt.server.register("Push", handler)
    stub = rt.make_stub(svc)
    t1 = rt.submit(stub, "Push", {"kvs": {"a": 1}, "payload": "good"})
    t2 = rt.submit(stub, "Push", {"kvs": {"b": 2}, "payload": "bad"})
    with pytest.raises(RuntimeError, match="handler down"):
        rt.drain()
    assert t1.result() == {"payload": "ok"}      # completed before the bomb
    assert stub.agents["Push"].read("a") == 1    # its addTo was flushed
    assert stub.agents["Push"].read("b") == 2    # failing call's addTo ran
    assert t2.abandoned
    with pytest.raises(RuntimeError, match="abandoned"):
        t2.result()                              # like a sequential raise


def test_drain_exception_keeps_other_channels_drainable():
    svc_a = monitor_service()
    svc_b = Service("Other")
    svc_b.rpc("Put", [Field("kvs", "STRINTMap")], [Field("msg")],
              nf({"AppName": "OTHER", "addTo": "R.kvs"}))
    rt = NetRPC()
    rt.server.register("Push", lambda r: (_ for _ in ()).throw(
        RuntimeError("down")))
    sa, sb = rt.make_stub(svc_a), rt.make_stub(svc_b)
    rt.submit(sa, "Push", {"kvs": {"a": 1}})
    tb = rt.submit(sb, "Put", {"kvs": {"x": 1}})
    with pytest.raises(RuntimeError, match="down"):
        rt.drain()
    # the other channel's queue survives the failed drain, old and new
    tb2 = rt.submit(sb, "Put", {"kvs": {"x": 2}})
    assert rt.drain() == 2
    assert tb.result() == {} and tb2.result() == {}
    assert sb.agents["Put"].read("x") == 3


def test_direct_call_drains_pending_submissions_first():
    """Mixed fronts on one channel preserve issue order: a submit()ted vote
    issued before a direct call() reaches the quorum counter first."""
    svc = Service("Vote")
    svc.rpc("Cast", [Field("kvs", "STRINTMap")], [Field("msg")],
            nf({"AppName": "VOTE",
                "CntFwd": {"to": "SRC", "threshold": 2, "key": "b"}}))
    rt = NetRPC()
    rt.server.register("Cast", lambda r: {"msg": "committed"})
    stub = rt.make_stub(svc)
    t = rt.submit(stub, "Cast", {"kvs": {"b1": 1}})      # vote 1 (queued)
    out = stub.call("Cast", {"kvs": {"b1": 1}})          # vote 2 (direct)
    assert t.result() == {}                  # queued vote ran first, cnt=1
    assert out == {"msg": "committed"}       # direct call hit the quorum


def test_ticket_result_before_drain_raises():
    rt = NetRPC()
    stub = rt.make_stub(monitor_service())
    t = rt.submit(stub, "Push", {"kvs": {"a": 1}})
    with pytest.raises(RuntimeError):
        t.result()
    rt.drain()
    assert t.result() == {}


# ---- the device lane: every flush a multi-segment transmit ------------------

SEG, N_SEGMENTS = 64, 16
# a 10-slot host partition first, so the device partition starts at slot
# 10 of segment 0 and ends inside segment 6
OFFSET, N_DEV = 10, 6 * SEG + 22


def _device_stub(pkg):
    """(runtime, typed stub of a device gradient service spanning 7
    segments) of one package."""
    if pkg == "jax":
        import repro.api as inc
        from repro.core.channel import Controller
        from repro.core.inc_map import SwitchMemory
        from repro.core.rpc import NetRPC as RPC
        switch = SwitchMemory(N_SEGMENTS, SEG)
    else:
        inc, Controller, RPC = tinc, TController, _NetRPC
        switch = TSwitch(N_SEGMENTS, SEG, device="cpu")
    rt = RPC(controller=Controller(switch=switch))

    @inc.service(app="pad")
    class Pad:
        @inc.rpc(request_msg="P", reply_msg="Q")
        def Push(self, tensor: inc.Agg[inc.FPArray](precision=4)
                 ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    @inc.service(app="dev-grad")
    class Grad:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=4, clear="copy", device=True)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    rt.make_stub(Pad, n_slots=OFFSET)
    return rt, rt.make_stub(Grad, n_slots=N_DEV)


def _device_run(pkg, mode, reqs):
    """Replies (as numpy) and switch registers of ``reqs`` through one
    package's device lane, sequential or batched. The first request is a
    call of its own in every mode: its misses map the partition's slots,
    so the later flushes hit the device segments."""
    rt, stub = _device_stub(pkg)
    legacy = stub.legacy
    out = [legacy.call("Update", reqs[0])]
    if mode == "sequential":
        out += [legacy.call("Update", r) for r in reqs[1:]]
    elif mode == "call_batch":
        out += legacy.call_batch("Update", reqs[1:])
    else:
        tickets = [rt.submit(legacy, "Update", r) for r in reqs[1:]]
        rt.drain()
        out += [t.result() for t in tickets]
    replies = [np.asarray(r["tensor"].cpu() if isinstance(
        r["tensor"], torch.Tensor) else r["tensor"]) for r in out]
    regs = [np.asarray(r.cpu() if isinstance(r, torch.Tensor) else r)
            for r in rt.controller.switch.state_dict()["regs"]]
    return replies, np.stack(regs)


def _device_reqs(saturating):
    rng = np.random.RandomState(5)
    reqs = [{"tensor": (rng.randn(N_DEV) * 3).astype(np.float32)}
            for _ in range(5)]
    if saturating:          # 3e9 at precision 4: past the int32 range
        reqs[3]["tensor"][:4] = np.float32([3e5, -3e5, 0.5e-4, 1.5e-4])
    return reqs


def _same_run(got, want):
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("mode", ["submit_drain", "call_batch"])
def test_device_lane_multi_segment_batch_equals_sequential(mode):
    reqs = _device_reqs(saturating=False)
    seq = _device_run("torch", "sequential", reqs)
    ops.reset_counts()
    bat = _device_run("torch", mode, reqs)
    # every flush that hits transmits over 7 segments in one plain call
    # (one launch on the card): at most one a call, never one a segment
    assert 0 < ops.plain_counts()["fused_addto"] <= len(reqs)
    _same_run(bat, seq)
    _same_run(_device_run("jax", mode, reqs), seq)
    assert all(r.any() for r in seq[0])


@pytest.mark.parametrize("mode", ["sequential", "submit_drain", "call_batch"])
def test_device_lane_multi_segment_saturating_matches_jax(mode):
    """A call whose values saturate: each front of the port equals the
    same front of the JAX package. (Batched and sequential replies differ
    here in both packages: the batched lane does not keep the sentinel of
    a saturated call; ROADMAP queue 3.)"""
    reqs = _device_reqs(saturating=True)
    got = _device_run("torch", mode, reqs)
    _same_run(got, _device_run("jax", mode, reqs))
    if mode == "sequential":
        assert got[0][3][0] == np.float32(2 ** 31 - 1) / np.float32(10 ** 4)

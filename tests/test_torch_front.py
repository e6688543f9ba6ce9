"""The port's RPC layer, data-plane controller and NetFilter against the
JAX package: the 15 tests of ``tests/test_rpc.py``, ``tests/test_channel.py``
and ``tests/test_netfilter.py`` mirrored under their names.

Each body runs once on the reference and once on the port (every runtime
on ``device="cpu"``) through ``_torch_front``; what a test reads (replies,
agent reads, partition bases, poll events, a NetFilter's fields) must be
equal between the two, and each run asserts what the reference test
asserts. Validation tests assert the same exception type and message on
both.
"""
import json

import numpy as np
import pytest

from _torch_front import mirror


def nf(pk, d):
    return pk.NetFilter.from_dict(d)


# ---- tests/test_rpc.py ------------------------------------------------------

def _sync_agtr(pk):
    svc = pk.Service("Gradient")
    svc.rpc("Update",
            [pk.Field("tensor", "FPArray")], [pk.Field("tensor", "FPArray")],
            nf(pk, {"AppName": "DT-1", "Precision": 4,
                    "get": "AgtrGrad.tensor", "addTo": "NewGrad.tensor",
                    "clear": "copy", "modify": "nop",
                    "CntFwd": {"to": "ALL", "threshold": 2,
                               "key": "ClientID"}}))
    rt = pk.NetRPC()
    c1 = rt.make_stub(svc)
    c2 = rt.make_stub(svc)
    g1 = np.array([0.5, -1.25, 2.0])
    g2 = np.array([1.5, 0.25, -1.0])
    r1 = c1.call("Update", {"tensor": g1})
    assert r1 == {}
    r2 = c2.call("Update", {"tensor": g2})
    got = np.array([r2["tensor"][i] for i in range(3)])
    np.testing.assert_allclose(got, g1 + g2, atol=1e-4)
    return r1, r2


def test_sync_agtr_gradient_aggregation():
    mirror(_sync_agtr)


def _wordcount(pk):
    svc = pk.Service("MapReduce")
    svc.rpc("ReduceByKey", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
            nf(pk, {"AppName": "MR-1", "addTo": "ReduceRequest.kvs"}))
    svc.rpc("Query", [pk.Field("msg")], [pk.Field("kvs", "STRINTMap")],
            nf(pk, {"AppName": "MR-1", "get": "QueryReply.kvs"}))
    rt = pk.NetRPC()
    stub = rt.make_stub(svc)
    replies = [stub.call("ReduceByKey", {"kvs": {"the": 3, "fox": 1}}),
               stub.call("ReduceByKey", {"kvs": {"the": 2, "dog": 1}})]
    out = stub.call("Query", {"kvs": {"the": 0, "fox": 0, "dog": 0}})
    assert out["kvs"]["the"] == 5
    assert out["kvs"]["fox"] == 1 and out["kvs"]["dog"] == 1
    return replies, out


def test_async_agtr_mapreduce_wordcount():
    mirror(_wordcount)


def _monitoring(pk):
    svc = pk.Service("Monitor")
    svc.rpc("MonitorCall", [pk.Field("kvs", "STRINTMap"),
                            pk.Field("payload")],
            [pk.Field("payload")],
            nf(pk, {"AppName": "MON-1", "addTo": "MonitorRequest.kvs"}))
    rt = pk.NetRPC()
    rt.server.register("MonitorCall", lambda req: {"payload": "ok"})
    stub = rt.make_stub(svc)
    for _ in range(7):
        r = stub.call("MonitorCall", {"kvs": {"flow-a": 1}, "payload": "hi"})
    assert r["payload"] == "ok"
    assert stub.agents["MonitorCall"].read("flow-a") == 7
    return r, stub.agents["MonitorCall"].read("flow-a")


def test_keyvalue_monitoring_counters():
    mirror(_monitoring)


def _agreement(pk):
    svc = pk.Service("Vote")
    svc.rpc("CastVote", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
            nf(pk, {"AppName": "VOTE-1",
                    "CntFwd": {"to": "SRC", "threshold": 3,
                               "key": "ballot"}}))
    rt = pk.NetRPC()
    hits = []
    rt.server.register("CastVote", lambda req: hits.append(1) or
                       {"msg": "committed"})
    stub = rt.make_stub(svc)
    outs = [stub.call("CastVote", {"kvs": {"b1": 1}}) for _ in range(3)]
    assert outs[0] == {} and outs[1] == {}
    assert outs[2]["msg"] == "committed"
    assert len(hits) == 1
    return outs, len(hits)


def test_agreement_vote_counting_skips_server_until_quorum():
    mirror(_agreement)


def _modify(pk):
    svc = pk.Service("Mod")
    svc.rpc("Push", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
            nf(pk, {"AppName": "MOD-1", "addTo": "R.kvs",
                    "modify": {"op": "max", "para": 10}}))
    rt = pk.NetRPC()
    stub = rt.make_stub(svc)
    stub.call("Push", {"kvs": {"k": 3}})
    assert stub.agents["Push"].read("k") == 10
    return stub.agents["Push"].read("k")


def test_stream_modify_applied_to_request():
    mirror(_modify)


# ---- tests/test_channel.py --------------------------------------------------

def cnf(pk, name, **kw):
    return pk.NetFilter.from_dict({"AppName": name, **kw})


def _register(pk):
    c = pk.Controller()
    ch = c.register(cnf(pk, "app-1", addTo="R.kvs"))
    assert c.lookup("app-1") is ch
    assert ch.app_type == "AsyncAgtr"
    with pytest.raises(ValueError) as ei:
        c.register(cnf(pk, "app-1"))
    return ch.gaid, ch.app_type, str(ei.value)


def test_register_and_lookup():
    mirror(_register)


def _partitions(pk):
    c = pk.Controller()
    a = c.register(cnf(pk, "a", addTo="R.kvs"), n_slots=100)
    b = c.register(cnf(pk, "b", addTo="R.kvs"), n_slots=100)
    assert a.server.base != b.server.base
    a.client().addto({"k": 1})
    b.client().addto({"k": 5})
    assert a.client().read("k") == 1
    assert b.client().read("k") == 5
    return (a.server.base, b.server.base, a.client().read("k"),
            b.client().read("k"))


def test_partitions_are_fcfs_and_isolated():
    mirror(_partitions)


def _release(pk):
    c = pk.Controller()
    ch = c.register(cnf(pk, "a"), n_slots=100)
    tail = c.switch._next_free
    ch.close()
    assert "a" not in c.by_name
    assert c.switch._next_free < tail
    return tail, c.switch._next_free


def test_release_frees_name_and_memory():
    mirror(_release)


def _timeouts(pk):
    c = pk.Controller(t1=10.0, t2=30.0)
    ch = c.register(cnf(pk, "stale", addTo="R.kvs"))
    cl = ch.client()
    cl.addto({"x": 42})
    first = c.poll()
    assert first == []
    c.advance(11)
    level1 = c.poll()
    assert level1 == [(ch.gaid, 1)]
    assert ch.server.mapping == {}
    assert cl.read("x") == 42
    c.advance(25)
    level2 = c.poll()
    assert level2 == [(ch.gaid, 2)]
    assert "stale" not in c.by_name
    assert any(v == 42 for v in c.delivered[ch.gaid].values())
    return first, level1, level2, dict(c.delivered[ch.gaid])


def test_two_level_timeout_reclaim():
    mirror(_timeouts)


def _touch(pk):
    c = pk.Controller(t1=10.0, t2=30.0)
    ch = c.register(cnf(pk, "busy"))
    c.advance(8)
    ch.touch()
    c.advance(8)
    events = c.poll()
    assert events == []
    return events


def test_touch_resets_timeout():
    mirror(_touch)


# ---- tests/test_netfilter.py ------------------------------------------------

def _fig3(pk, path):
    nf_json = {
        "AppName": "DT-1", "Precision": 8,
        "get": "AgtrGrad.tensor", "addTo": "NewGrad.tensor",
        "clear": "copy", "modify": "nop",
        "CntFwd": {"to": "ALL", "threshold": 2, "key": "ClientID"},
    }
    path.write_text(json.dumps(nf_json))
    f = pk.NetFilter.load(path)
    assert f.app_name == "DT-1" and f.precision == 8
    assert f.scale == 1e8
    assert f.cnt_fwd.enabled and f.cnt_fwd.to == "ALL"
    assert f.app_type() == "SyncAgtr"
    assert f.to_dict()["addTo"] == "NewGrad.tensor"
    return f.to_dict(), f.scale, f.app_type()


def test_paper_example_fig3(tmp_path):
    mirror(_fig3, tmp_path / "agtr.nf")


def _classify(pk):
    base = dict(AppName="x", Precision=0)
    kinds = [pk.NetFilter.from_dict(d).app_type() for d in (
        {**base, "addTo": "Req.kvs", "CntFwd": {"to": "SRC"}},
        {**base, "get": "Reply.kvs"},
        {**base, "CntFwd": {"to": "SRC", "threshold": 1, "key": "L.kvs"}},
        {**base, "addTo": "A.t", "get": "B.t", "clear": "copy"})]
    assert kinds == ["AsyncAgtr", "KeyValue", "Agreement", "SyncAgtr"]
    return kinds


def test_app_type_classification():
    mirror(_classify)


def _rejects(pk, bad):
    with pytest.raises((ValueError, KeyError)) as ei:
        pk.NetFilter.from_dict(bad)
    return type(ei.value).__name__, str(ei.value)


@pytest.mark.parametrize("bad", [
    {"AppName": "x", "Precision": 11},
    {"AppName": "bad name!"},
    {"AppName": "x", "clear": "wipe"},
    {"AppName": "x", "modify": {"op": "divide"}},
    {"AppName": "x", "CntFwd": {"to": "EVERYONE"}},
    {"AppName": "x", "unknown_field": 1},
    {"AppName": "x", "modify": {"op": "max", "parma": 3}},
    {"AppName": "x", "CntFwd": {"to": "SRC", "treshold": 2, "key": "k"}},
    {"AppName": "x", "modify": 7},
    {"AppName": "x", "CntFwd": [1, 2]},
])
def test_validation_rejects(bad):
    mirror(_rejects, bad)


def _names(pk, bad, needle):
    with pytest.raises(ValueError) as ei:
        pk.NetFilter.from_dict(bad)
    msg = str(ei.value)
    assert "DT-9" in msg, msg
    assert needle in msg, msg
    return msg


@pytest.mark.parametrize("bad,needle", [
    ({"AppName": "DT-9", "unknown_field": 1}, "unknown_field"),
    ({"AppName": "DT-9", "Precision": 11}, "Precision"),
    ({"AppName": "DT-9", "clear": "wipe"}, "clear"),
    ({"AppName": "DT-9", "modify": {"op": "max", "parma": 3}}, "parma"),
    ({"AppName": "DT-9", "CntFwd": {"treshold": 2}}, "treshold"),
    ({"AppName": "DT-9", "CntFwd": {"to": "EVERYONE"}}, "EVERYONE"),
])
def test_errors_name_offending_key_and_app(bad, needle):
    mirror(_names, bad, needle)


def _test_and_set(pk):
    f = pk.NetFilter.from_dict({"AppName": "lock", "CntFwd":
                                {"to": "SRC", "threshold": 1, "key": "k"}})
    assert f.cnt_fwd.enabled and f.cnt_fwd.threshold == 1
    return f.to_dict()


def test_cntfwd_threshold_one_is_test_and_set():
    mirror(_test_and_set)

"""The port's typed declarative schema (``core/schema.py`` and
``repro_torch/api.py``) against the JAX package: the 26 tests of
``tests/test_schema.py`` mirrored under their names.

Each body runs once on the reference and once on the port (every runtime
on ``device="cpu"``) through ``_torch_front``:

  golden        each example service compiles to the same
                ``NetFilter.to_dict()`` in both packages, and to the
                reference's legacy JSON.
  validation    the same ``SchemaError`` (type and message) on both.
  equivalence   typed-stub and legacy-stub replies, errors and map state
                are equal within each package and between the two.
  bulk async    ``.batch()`` and the schema's ``DrainPolicy`` ride the
                scheduler alike in both: replies, reads and the
                deterministic counters of ``scheduling_report()``.

The bulk runs keep the reference's policies; the only trigger they can
race on (the time trigger, ``max_delay`` 30 s) cannot fire in a test.
"""
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_front import examples, mirror, port, ref, same

GOLDEN = {
    ("Gradient", "Update"): {
        "AppName": "DT-1", "Precision": 8,
        "get": "AgtrGrad.tensor", "addTo": "NewGrad.tensor",
        "clear": "copy", "modify": "nop",
        "CntFwd": {"to": "ALL", "threshold": 2, "key": "ClientID"},
    },
    ("Monitor", "MonitorCall"): {
        "AppName": "MON-1", "Precision": 0,
        "addTo": "MonitorRequest.kvs",
    },
    ("Monitor", "Query"): {
        "AppName": "MON-1", "Precision": 0, "get": "QueryReply.kvs",
    },
    ("MapReduce", "ReduceByKey"): {
        "AppName": "MR-1", "Precision": 0, "addTo": "ReduceRequest.kvs",
    },
    ("MapReduce", "Query"): {
        "AppName": "MR-1", "Precision": 0, "get": "QueryReply.kvs",
    },
    ("Paxos", "Prepare"): {
        "AppName": "paxos-prepare",
        "CntFwd": {"to": "SRC", "threshold": 1, "key": "kvs"},
    },
    ("Paxos", "Accept"): {
        "AppName": "paxos-accept",
        "CntFwd": {"to": "ALL", "threshold": 2, "key": "kvs"},
    },
}


def _schemas(pk):
    return {c.__inc_schema__.name: c.__inc_schema__
            for c in examples(pk).values()}


# ---- golden -----------------------------------------------------------------

def _golden(pk):
    schemas = _schemas(pk)
    out = {}
    for (svc, rpc_name), legacy in GOLDEN.items():
        compiled = schemas[svc].rpcs[rpc_name].netfilter.to_dict()
        want = pk.NetFilter.from_dict(legacy).to_dict()
        assert compiled == want, (svc, rpc_name, compiled, want)
        out[f"{svc}.{rpc_name}"] = compiled
    return out


def test_golden_example_netfilters_byte_identical():
    mirror(_golden)


def _table1(pk):
    schemas = _schemas(pk)
    kinds = [schemas[s].rpcs[r].netfilter.app_type() for s, r in (
        ("Gradient", "Update"), ("MapReduce", "ReduceByKey"),
        ("Monitor", "Query"), ("Paxos", "Accept"))]
    assert kinds == ["SyncAgtr", "AsyncAgtr", "KeyValue", "Agreement"]
    return kinds


def test_example_schemas_classify_like_table1():
    mirror(_table1)


# ---- validation: the same SchemaError in both --------------------------------

def _raises(pk, make, pattern):
    with pytest.raises(pk.inc.SchemaError, match=pattern) as ei:
        make(pk.inc)
    return str(ei.value)


def _two_agg(inc):
    @inc.service(app="X")
    class Bad:
        @inc.rpc
        def P(self, a: inc.Agg[inc.STRINTMap],
              b: inc.Agg[inc.STRINTMap]): ...


def test_two_agg_fields_rejected():
    mirror(_raises, _two_agg, r"Bad\.P.*one Map\.addTo")


def _get_request(inc):
    @inc.service(app="X")
    class Bad:
        @inc.rpc
        def P(self, a: inc.Get[inc.STRINTMap]): ...


def test_get_on_request_side_rejected():
    mirror(_raises, _get_request, r"Bad\.P.*reply-side")


def _agg_reply(inc):
    @inc.service(app="X")
    class Bad:
        @inc.rpc
        def P(self, a: inc.Plain) -> {"t": inc.Agg[inc.FPArray]}: ...


def test_agg_on_reply_side_rejected():
    mirror(_raises, _agg_reply, r"Bad\.P.*request-side")


def test_unknown_annotation_option_rejected():
    mirror(_raises, lambda inc: inc.Agg[inc.FPArray](precison=8),
           r"precison")


def test_precision_out_of_range_rejected():
    mirror(_raises, lambda inc: inc.Agg[inc.FPArray](precision=11),
           r"\[0, 9\]")


def test_bad_clear_policy_rejected():
    mirror(_raises, lambda inc: inc.ReadMostly[inc.STRINTMap](clear="wipe"),
           r"clear")


def test_bad_modify_op_rejected():
    mirror(_raises,
           lambda inc: inc.Agg[inc.STRINTMap](modify=("divide", 3)),
           r"divide")


def test_cntfwd_threshold_without_key_rejected():
    mirror(_raises, lambda inc: inc.CntFwd(to="ALL", threshold=2),
           r"vote\s+key")


def test_cntfwd_bad_target_rejected():
    mirror(_raises,
           lambda inc: inc.CntFwd(to="EVERYONE", threshold=1, key="k"),
           r"EVERYONE")


def _conflicting_clear(inc):
    @inc.service(app="X")
    class Bad:
        @inc.rpc
        def P(self, a: inc.Agg[inc.FPArray](clear="copy")
              ) -> {"a": inc.Get[inc.FPArray](clear="lazy")}: ...


def test_conflicting_clear_between_annotations_rejected():
    mirror(_raises, _conflicting_clear, r"Bad\.P.*conflicting")


def _missing_app(inc):
    @inc.service
    class Bad:
        @inc.rpc
        def P(self, a: inc.Plain): ...


def test_missing_app_rejected():
    mirror(_raises, _missing_app, r"Bad\.P.*AppName")


def _no_rpcs(inc):
    @inc.service(app="X")
    class Bad:
        def helper(self):
            return 1


def test_service_without_rpcs_rejected():
    mirror(_raises, _no_rpcs, r"at least one RPC")


def _conflicting_drain(inc):
    @inc.service(app="X")
    class Bad:
        @inc.rpc(drain=inc.DrainPolicy(max_batch=2))
        def P(self, a: inc.Agg[inc.STRINTMap]): ...

        @inc.rpc(drain=inc.DrainPolicy(max_batch=8), reply_msg="Y")
        def Q(self, a: inc.ReadMostly[inc.STRINTMap]): ...


def test_conflicting_drain_overrides_on_shared_channel_rejected():
    mirror(_raises, _conflicting_drain, r"conflicting DrainPolicy")


def _readmostly_agg(inc):
    @inc.service(app="X")
    class Bad:
        @inc.rpc
        def P(self, a: inc.Agg[inc.STRINTMap],
              b: inc.ReadMostly[inc.STRINTMap]): ...


def test_readmostly_plus_agg_rejected():
    mirror(_raises, _readmostly_agg, r"either a write stream")


def _call_site(pk):
    inc = pk.inc

    @inc.service(app="CALLCHK")
    class Svc:
        @inc.rpc
        def Push(self, kvs: inc.Agg[inc.STRINTMap]): ...
    stub = pk.NetRPC().make_stub(Svc)
    with pytest.raises(inc.SchemaError, match=r"Svc\.Push.*kv_typo") as ei:
        stub.Push(kv_typo={"a": 1})
    return str(ei.value)


def test_unknown_request_field_at_call_site():
    mirror(_call_site)


# ---- equivalence: typed stub == legacy Stub, in both packages ---------------

CLEARS = ("nop", "copy")
MODIFIES = ("nop", ("max", 40), ("add", 3))


def _legacy_service(pk, app, precision, clear, modify, threshold):
    svc = pk.Service("Rand")
    mod = ("nop" if modify == "nop"
           else {"op": modify[0], "para": modify[1]})
    svc.rpc("Push", [pk.Field("kvs", "STRINTMap"), pk.Field("payload")],
            [pk.Field("payload")],
            pk.NetFilter.from_dict({"AppName": app, "Precision": precision,
                                    "addTo": "Req.kvs", "modify": mod}))
    svc.rpc("Query", [pk.Field("kvs", "STRINTMap")],
            [pk.Field("kvs", "STRINTMap")],
            pk.NetFilter.from_dict({"AppName": app, "Precision": precision,
                                    "get": "QueryReply.kvs",
                                    "clear": clear}))
    svc.rpc("Cast", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
            pk.NetFilter.from_dict({"AppName": f"{app}-vote", "CntFwd":
                                    {"to": "SRC", "threshold": threshold,
                                     "key": "b"}}))
    return svc


def _typed_service(pk, app, precision, clear, modify, threshold):
    inc = pk.inc

    def Push(self, kvs, payload): ...
    Push.__annotations__ = {
        "kvs": inc.Agg[inc.STRINTMap](precision=precision, modify=modify),
        "payload": inc.Plain,
        "return": {"payload": inc.Plain}}
    Push = inc.rpc(request_msg="Req")(Push)

    def Query(self, kvs): ...
    Query.__annotations__ = {
        "kvs": inc.ReadMostly[inc.STRINTMap](precision=precision,
                                             clear=clear)}
    Query = inc.rpc(Query)

    def Cast(self, kvs): ...
    Cast.__annotations__ = {"kvs": inc.STRINTMap,
                            "return": {"msg": inc.Plain}}
    Cast = inc.rpc(app=f"{app}-vote",
                   cnt_fwd=inc.CntFwd(to="SRC", threshold=threshold,
                                      key="b"))(Cast)

    cls = type("Rand", (), {"Push": Push, "Query": Query, "Cast": Cast})
    return inc.service(app=app, name="Rand")(cls)


def _handlers(rt):
    def push_handler(req):
        if req.get("payload") == "bad":
            raise RuntimeError("handler down")
        return {"payload": "ok"}
    rt.server.register("Push", push_handler)
    rt.server.register("Cast", lambda r: {"msg": "committed"})


_METHODS = ("Push", "Query", "Cast")


def _reqs_from_ops(ops):
    reqs = []
    for mi, fail, kvs in ops:
        m = _METHODS[mi % 3]
        if m == "Push":
            reqs.append((m, {"kvs": {f"k{ki % 6}": v for ki, v in kvs},
                             "payload": "bad" if fail == 3 else "p"}))
        elif m == "Query":
            reqs.append((m, {"kvs": {f"k{ki % 6}": 0 for ki, _ in kvs}}))
        else:
            reqs.append((m, {"kvs": {f"b{ki % 3}": 1 for ki, _ in kvs}}))
    return reqs


def _typed_vs_legacy(pk, app, precision, clear, modify, threshold, reqs):
    probe = [f"k{i}" for i in range(6)]
    args = (app, precision, clear, modify, threshold)
    lrt = pk.NetRPC()
    _handlers(lrt)
    lstub = lrt.make_stub(_legacy_service(pk, *args))
    want, want_err = [], []
    for m, r in reqs:
        try:
            want.append(lstub.call(m, dict(r)))
            want_err.append(None)
        except RuntimeError as e:
            want.append(None)
            want_err.append(str(e))
    want_state = [lstub.agents["Push"].read(k) for k in probe]

    trt = pk.NetRPC()
    _handlers(trt)
    tstub = trt.make_stub(_typed_service(pk, *args))
    got, got_err = [], []
    for m, r in reqs:
        f = getattr(tstub, m)(**dict(r))
        if f.exception() is None:
            got.append(f.result())
            got_err.append(None)
        else:
            got.append(None)
            got_err.append(str(f.exception()))
    got_state = [tstub.agents["Push"].read(k) for k in probe]
    assert got == want
    assert got_err == want_err
    assert got_state == want_state
    out = {"replies": got, "errors": got_err, "state": got_state}

    push_reqs = [dict(r) for m, r in reqs if m == "Push"]
    if push_reqs:
        l2 = pk.NetRPC()
        _handlers(l2)
        ls = l2.make_stub(_legacy_service(pk, *args))
        t2 = pk.NetRPC()
        _handlers(t2)
        ts = t2.make_stub(_typed_service(pk, *args))
        try:
            lwant = ls.call_batch("Push", [dict(r) for r in push_reqs])
            lerr = None
        except RuntimeError as e:
            lwant, lerr = None, str(e)
        futs = ts.Push.batch([dict(r) for r in push_reqs])
        if lerr is None:
            assert [f.result() for f in futs] == lwant
        else:
            errs = [f.exception() for f in futs]
            assert any(str(e) == lerr for e in errs if e is not None)
        batch_state = [ts.agents["Push"].read(k) for k in probe]
        assert batch_state == [ls.agents["Push"].read(k) for k in probe]
        out["batch"] = {"replies": lwant, "error": lerr,
                        "state": batch_state,
                        "outcomes": [str(f.exception()) for f in futs]}
    return out


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2),
       st.sampled_from(CLEARS),
       st.sampled_from(MODIFIES),
       st.integers(1, 3),
       st.lists(st.tuples(st.integers(0, 2), st.integers(0, 3),
                          st.lists(st.tuples(st.integers(0, 7),
                                             st.integers(-40, 40)),
                                   min_size=1, max_size=4)),
                min_size=1, max_size=10))
def test_typed_stub_equals_legacy_stub(precision, clear, modify, threshold,
                                       ops):
    """Within each package typed == legacy (replies, errors, state, and
    the bulk front); across the packages every one of those is equal."""
    mod_tag = modify if isinstance(modify, str) else f"{modify[0]}{modify[1]}"
    app = f"EQ-{precision}-{clear}-{mod_tag}-{threshold}"
    mirror(_typed_vs_legacy, app, precision, clear, modify, threshold,
           _reqs_from_ops(ops))


# ---- bulk async through the scheduler ----------------------------------------

def _push_handler(req):
    if req.get("payload") == "bad":
        raise RuntimeError("handler down")
    return {"payload": "ok"}


def _batch_mid_failure(pk):
    inc = pk.inc

    @inc.service(app="BF-1",
                 drain=inc.DrainPolicy(max_batch=3, max_delay=30.0,
                                       eager_window=False))
    class Svc:
        @inc.rpc(request_msg="R")
        def Push(self, kvs: inc.Agg[inc.STRINTMap], payload: inc.Plain
                 ) -> {"payload": inc.Plain}: ...

    rt = pk.IncRuntime()
    try:
        rt.server.register("Push", _push_handler)
        stub = rt.make_stub(Svc)
        futs = stub.Push.batch([
            {"kvs": {"a": 1}, "payload": "good"},
            {"kvs": {"b": 2}, "payload": "bad"},
            {"kvs": {"c": 3}, "payload": "good"},
        ])
        first = futs[0].result(timeout=5)
        assert first == {"payload": "ok"}
        with pytest.raises(RuntimeError, match="handler down") as e1:
            futs[1].result(timeout=5)
        with pytest.raises(RuntimeError, match="abandoned") as ei:
            futs[2].result(timeout=5)
        assert "handler down" in str(ei.value.__cause__)
        reads = [stub.agents["Push"].read(k) for k in "abc"]
        assert reads[:2] == [1, 2]
        return first, str(e1.value), str(ei.value), reads
    finally:
        rt.close(flush=False)


def test_batch_mid_failure_future_semantics():
    mirror(_batch_mid_failure)


def _size_svc(pk, app, max_batch, **kw):
    inc = pk.inc
    drain = inc.DrainPolicy(max_batch=max_batch, max_delay=30.0,
                            eager_window=False, **kw)

    @inc.service(app=app, drain=drain)
    class Svc:
        @inc.rpc(request_msg="R")
        def Push(self, kvs: inc.Agg[inc.STRINTMap]): ...
    return Svc


def _batch_triggers(pk):
    rt = pk.IncRuntime()
    try:
        stub = rt.make_stub(_size_svc(pk, "BT-1", 4))
        futs = stub.Push.batch([{"kvs": {"x": 1}} for _ in range(12)])
        replies = [f.result(timeout=5) for f in futs]
        ch = stub.channels["Push"]
        assert stub.agents["Push"].read("x") == 12
        assert ch.stats.drain_triggers["size"] == 3
        assert ch.stats.mean_drained_batch == 4.0
        rep = rt.scheduling_report()["BT-1"]
        assert rep["drained_calls"] == 12
        return (replies, stub.agents["Push"].read("x"),
                dict(ch.stats.drain_triggers), rep["drained_calls"],
                rep["drained_batches"], rep["acks"])
    finally:
        rt.close()


def test_batch_async_rides_scheduler_triggers():
    mirror(_batch_triggers)


def _batch_backpressure(pk):
    """``.batch()`` enqueues under one hold of the scheduler's lock, so
    the 9th call waits for room whatever the workers do: the admission
    wait is deterministic, as in the reference."""
    inc = pk.inc

    @inc.service(app="BP-1",
                 drain=inc.DrainPolicy(max_batch=8, max_delay=0.001,
                                       backlog_factor=1, ecn_threshold=8,
                                       service_rate=500.0))
    class Svc:
        @inc.rpc(request_msg="R")
        def Push(self, kvs: inc.Agg[inc.STRINTMap], payload: inc.Plain
                 ) -> {"payload": inc.Plain}: ...

    rt = pk.IncRuntime()
    try:
        rt.server.register(
            "Push", lambda r: (__import__("time").sleep(0.001),
                               {"payload": "ok"})[1])
        stub = rt.make_stub(Svc)
        futs = stub.Push.batch([{"kvs": {"k": 1}, "payload": "p"}
                                for _ in range(64)])
        replies = [f.result(timeout=30) for f in futs]
        assert replies == [{"payload": "ok"}] * 64
        ch = stub.channels["Push"]
        assert ch.stats.admission_waits > 0
        assert ch.stats.max_queue_depth <= 8 + rt.policy.w_max
        assert stub.agents["Push"].read("k") == 64
        return replies, stub.agents["Push"].read("k")
    finally:
        rt.close()


def test_batch_async_backpressure_bounds_queue():
    mirror(_batch_backpressure)


def _per_channel_policy(pk):
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=1000, max_delay=30.0,
                                             eager_window=False))
    try:
        s = rt.make_stub(_size_svc(pk, "PC-small", 2))
        b = rt.make_stub(_size_svc(pk, "PC-big", 6))
        sf = [s.Push(kvs={"a": 1}) for _ in range(2)]
        bf = [b.Push(kvs={"a": 1}) for _ in range(6)]
        for f in sf + bf:
            f.result(timeout=5)
        out = []
        for stub, n in ((s, 2.0), (b, 6.0)):
            stats = stub.channels["Push"].stats
            assert stats.drain_triggers["size"] == 1
            assert stats.mean_drained_batch == n
            out.append((dict(stats.drain_triggers), stats.mean_drained_batch,
                        stub.agents["Push"].read("a")))
        return out
    finally:
        rt.close()


def test_schema_drain_policy_applies_per_channel():
    mirror(_per_channel_policy)


def _attribution(pk):
    rt = pk.IncRuntime()
    try:
        stub = rt.make_stub(_size_svc(pk, "CS-1", 4))
        for _ in range(3):
            stub.Push(kvs={"e": 1}).result(timeout=5)
        futs = [stub.Push(kvs={"e": 1}) for _ in range(4)]
        for f in futs:
            f.result(timeout=5)
        st_ = stub.channels["Push"].stats
        st_.check_consistent()
        rep = rt.scheduling_report()["CS-1"]
        assert rep["calls"] == rep["explicit_calls"] + rep["drained_calls"]
        st_.drained_calls += 1
        with pytest.raises(AssertionError, match="attribution drift") as ei:
            rt.scheduling_report()
        st_.drained_calls -= 1
        return ({k: rep[k] for k in ("calls", "explicit_calls",
                                     "drained_calls", "drained_batches")},
                str(ei.value))
    finally:
        rt.close()


def test_channelstats_attribution_audit():
    mirror(_attribution)


# ---- the inline (NetRPC) futures-first surface -------------------------------

def _inline_svc(pk, app):
    inc = pk.inc

    @inc.service(app=app)
    class Svc:
        @inc.rpc(request_msg="R")
        def Push(self, kvs: inc.Agg[inc.STRINTMap]): ...

        @inc.rpc(reply_msg="Y")
        def Query(self, kvs: inc.ReadMostly[inc.STRINTMap]): ...
    return Svc


def _inline_futures(pk):
    stub = pk.NetRPC().make_stub(_inline_svc(pk, "NF-1"))
    f = stub.Push(kvs={"a": 2})
    assert f.done()
    assert f.result() == {}
    q = stub.Query(kvs={"a": 0}).result()
    assert q["kvs"] == {"a": 2}
    return f.result(), q


def test_netrpc_futures_resolve_inline():
    mirror(_inline_futures)


def _pending_first(pk):
    rt = pk.NetRPC()
    stub = rt.make_stub(_inline_svc(pk, "NF-2"))
    t = rt.submit(stub.legacy, "Push", {"kvs": {"x": 5}})
    futs = stub.Query.batch([{"kvs": {"x": 0}}])
    got = futs[0].result()
    assert got["kvs"] == {"x": 5}
    assert t.done
    return got


def test_netrpc_batch_runs_pending_submissions_first():
    mirror(_pending_first)


def _device_gradient(inc):
    """The port's ``quickstart.Gradient`` declared in ``inc``'s package:
    the reference's with ``device=True`` (the port's quickstart runs the
    device lane, the card's)."""
    @inc.service(app="DT-1",
                 drain=inc.DrainPolicy(max_batch=2, max_delay=0.05,
                                       eager_window=False))
    class Gradient:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad",
                 cnt_fwd=inc.CntFwd(to="ALL", threshold=2, key="ClientID"))
        def Update(self, tensor: inc.Agg[inc.FPArray](precision=8,
                                                      clear="copy",
                                                      device=True)
                   ) -> {"tensor": inc.Get[inc.FPArray]}: ...
    return Gradient


def _quickstart(pk, gradient):
    rt = pk.NetRPC()
    a, b = rt.make_stub(gradient), rt.make_stub(gradient)
    g1 = np.array([0.5, -1.25, 2.0])
    g2 = np.array([1.5, 0.25, -1.0])
    first = a.Update(tensor=g1).result()
    assert first == {}
    got = b.Update(tensor=g2).result()["tensor"]
    vals = np.array([got[i] for i in range(3)])
    np.testing.assert_allclose(vals, g1 + g2, atol=1e-6)
    return first, vals


def test_quickstart_flow_through_typed_stub():
    """Each package's own quickstart ``Gradient`` runs the flow; the
    port's declares ``device=True``, so its replies are fp32 where the
    reference's host lane replies in float64. The port's flow must equal
    the reference's under the port's declaration, bit for bit."""
    jx, tp = ref(), port()
    _quickstart(jx, examples(jx)["Gradient"])
    got = _quickstart(tp, examples(tp)["Gradient"])
    same(got, _quickstart(jx, _device_gradient(jx.inc)))
    assert examples(tp)["Gradient"].__inc_schema__.rpcs[
        "Update"].netfilter.to_dict() == _device_gradient(
            tp.inc).__inc_schema__.rpcs["Update"].netfilter.to_dict()


def test_port_schema_is_not_the_reference_schema():
    """The mirrors compare two packages, not one twice: the port's
    ``SchemaError`` and services are its own classes."""
    import repro_torch.api as tinc
    jinc = ref().inc
    assert tinc.SchemaError is not jinc.SchemaError
    assert tinc.service is not jinc.service
    same(sorted(n for n in dir(tinc) if not n.startswith("_")),
         sorted(n for n in dir(jinc) if not n.startswith("_")))

"""The port's sharded data plane (``IncRuntime(workers=N)``: the worker
pool, per-channel plane locks, the weighted-fair drain loop) against the
JAX package: the 18 tests of ``tests/test_runtime_shard.py`` mirrored
under their names.

Each body runs once on the reference and once on the port (every runtime
on ``device="cpu"``) through ``_torch_front``: within each package a
sharded run equals the ``workers=1`` oracle, as the reference asserts,
and across the packages the replies, final map state, outcome chains,
DRR pick shares and the untimed fields of ``scheduling_report()`` are
equal.

Steadiness: ``test_backpressure_wakeups_with_worker_pool`` holds its
handler until a producer thread has blocked on admission, instead of
the reference's 2 ms sleep that races four drain workers.
"""
import threading
import time

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_front import mirror, untimed


def nf(pk, d):
    return pk.NetFilter.from_dict(d)


def monitor_service(pk, app="MON"):
    svc = pk.Service("Monitor")
    svc.rpc("Push", [pk.Field("kvs", "STRINTMap"), pk.Field("payload")],
            [pk.Field("payload")],
            nf(pk, {"AppName": app, "addTo": "R.kvs"}))
    svc.rpc("Query", [pk.Field("kvs", "STRINTMap")],
            [pk.Field("kvs", "STRINTMap")],
            nf(pk, {"AppName": app, "get": "Y.kvs"}))
    svc.rpc("QueryClear", [pk.Field("kvs", "STRINTMap")],
            [pk.Field("kvs", "STRINTMap")],
            nf(pk, {"AppName": app, "get": "Y.kvs", "clear": "copy"}))
    return svc


def vote_service(pk, app="VOTE"):
    svc = pk.Service("Vote")
    svc.rpc("Cast", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
            nf(pk, {"AppName": app,
                    "CntFwd": {"to": "SRC", "threshold": 2, "key": "b"}}))
    return svc


def tensor_service(pk, app="TEN"):
    svc = pk.Service("Tensor")
    svc.rpc("Accum", [pk.Field("tensor", "FPArray")], [],
            nf(pk, {"AppName": app, "addTo": "R.tensor", "Precision": 4}))
    svc.rpc("Pull", [pk.Field("tensor", "FPArray")],
            [pk.Field("tensor", "FPArray")],
            nf(pk, {"AppName": app, "get": "Y.tensor", "Precision": 4}))
    return svc


def _policy(pk, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_delay", 30.0)
    kw.setdefault("eager_window", False)
    return pk.DrainPolicy(**kw)


def _apply(pk, ops, workers):
    rt = pk.IncRuntime(policy=_policy(pk), workers=workers)
    rt.server.register("Cast", lambda r: {"msg": "committed"})
    stubs = {"mon": rt.make_stub(monitor_service(pk)),
             "vote": rt.make_stub(vote_service(pk)),
             "ten": rt.make_stub(tensor_service(pk))}
    try:
        futs = []
        for kind, a, kvs in ops:
            if kind == 0:
                method = ("Push", "Query", "QueryClear")[a % 3]
                payload = ({f"k{k}": v for k, v in kvs} if method == "Push"
                           else {f"k{k}": 0 for k, _ in kvs})
                futs.append(stubs["mon"].call_async(method,
                                                    {"kvs": payload}))
            elif kind == 1:
                futs.append(stubs["vote"].call_async(
                    "Cast", {"kvs": {f"b{a % 4}": 1}}))
            else:
                method = ("Accum", "Pull")[a % 2]
                arr = np.array([v / 7.0 for _, v in kvs], np.float64)
                futs.append(stubs["ten"].call_async(method,
                                                    {"tensor": arr}))
        got = [f.result(timeout=30) for f in futs]
        state = ([stubs["mon"].agents["Push"].read(f"k{i}")
                  for i in range(8)]
                 + [stubs["ten"].agents["Accum"].server.read(i)
                    for i in range(6)])
        rt.scheduling_report()
        return got, state
    finally:
        rt.close()


def _sharded_vs_sequential(pk, ops):
    want, want_state = _apply(pk, ops, workers=1)
    got, got_state = _apply(pk, ops, workers=4)
    for w, g in zip(want, got):
        assert type(w) is type(g)
        if isinstance(w, dict) and "tensor" in w:
            assert w.keys() == g.keys()
            assert w["tensor"] == g["tensor"]
        else:
            assert w == g
    assert want_state == got_state
    return got, got_state


@settings(max_examples=6, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 5),
                          st.lists(st.tuples(st.integers(0, 7),
                                             st.integers(-50, 50)),
                                   min_size=1, max_size=4)),
                min_size=1, max_size=18))
def test_sharded_results_equal_sequential_oracle(ops):
    mirror(_sharded_vs_sequential, ops)


def _apply_failure(pk, n, bad, workers):
    rt = pk.IncRuntime(policy=_policy(pk, max_batch=max(n, 1)),
                       workers=workers)
    try:
        def handler(req):
            if req.get("payload") == "bad":
                raise RuntimeError("handler down")
            return {"payload": "ok"}
        rt.server.register("Push", handler)
        stub = rt.make_stub(monitor_service(pk))
        reqs = [{"kvs": {f"k{i % 4}": i + 1},
                 "payload": "bad" if i == bad else "good"}
                for i in range(n)]
        futs = stub.call_batch_async("Push", reqs)
        out = []
        for f in futs:
            exc = f.exception(timeout=30)
            if exc is None:
                out.append(("ok", f.result()))
            elif "abandoned" in str(exc):
                out.append(("abandoned", str(exc.__cause__)))
            else:
                out.append(("raised", str(exc)))
        state = [stub.agents["Push"].read(f"k{i}") for i in range(4)]
        return out, state
    finally:
        rt.close(flush=False)


def _chaining(pk, n, bad):
    want = _apply_failure(pk, n, bad, workers=1)
    got = _apply_failure(pk, n, bad, workers=4)
    assert got == want
    outcomes = [tag for tag, _ in got[0]]
    assert outcomes[:bad] == ["ok"] * bad
    assert outcomes[bad] == "raised"
    assert outcomes[bad + 1:] == ["abandoned"] * (n - bad - 1)
    return got


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 8), st.integers(0, 7))
def test_mid_batch_failure_chaining_matches_oracle(n, bad):
    mirror(_chaining, n, bad % n)


def _gpv_vs_dict(pk):
    ops = [(2, i, [(j, (i * 7 + j) % 23 - 11) for j in range(4)])
           for i in range(24)]
    prev = pk.rpc.set_gpv(True)
    try:
        want = _apply(pk, ops, workers=4)
        pk.rpc.set_gpv(False)
        got = _apply(pk, ops, workers=4)
    finally:
        pk.rpc.set_gpv(prev)
    assert want == got
    return got


def test_gpv_equals_dict_under_concurrent_drains():
    mirror(_gpv_vs_dict)


# ---- true concurrency across channels ---------------------------------------

def _overlap(pk):
    ev = {"A": threading.Event(), "B": threading.Event()}
    seen = {}

    def mk_handler(me, other):
        def handler(req):
            ev[me].set()
            seen[me] = ev[other].wait(timeout=10.0)
            return {"payload": "ok"}
        return handler

    rt = pk.IncRuntime(policy=_policy(pk, max_delay=0.001), workers=2)
    try:
        sa = rt.make_stub(monitor_service(pk, "CC-A"))
        sb = rt.make_stub(monitor_service(pk, "CC-B"))

        def route(req):
            return mk_handler(*(("A", "B") if req.get("payload") == "A"
                                else ("B", "A")))(req)
        rt.server.register("Push", route)
        fa = sa.call_async("Push", {"kvs": {"a": 1}, "payload": "A"})
        fb = sb.call_async("Push", {"kvs": {"b": 1}, "payload": "B"})
        out = (fa.result(timeout=30), fb.result(timeout=30))
        assert out == ({"payload": "ok"},) * 2
        assert seen == {"A": True, "B": True}, \
            "handlers never overlapped: the plane is still serial"
        return out, seen
    finally:
        rt.close()


def test_independent_channels_drain_concurrently():
    mirror(_overlap)


def _wakeups(pk):
    pol = pk.DrainPolicy(max_batch=8, max_delay=0.001, backlog_factor=1,
                         ecn_threshold=8, service_rate=200.0)
    rt = pk.IncRuntime(policy=pol, workers=4)
    gate = threading.Event()
    try:
        def handler(r):
            gate.wait(timeout=30)
            time.sleep(0.002)
            return {"payload": "ok"}
        rt.server.register("Push", handler)
        stub = rt.make_stub(monitor_service(pk))
        ch = stub.channels["Push"]
        futs = []

        def produce():
            for _ in range(48):
                futs.append(stub.call_async(
                    "Push", {"kvs": {"k": 1}, "payload": "p"}))
        producer = threading.Thread(target=produce)
        producer.start()
        deadline = time.monotonic() + 30
        while ch.stats.admission_waits == 0:
            assert time.monotonic() < deadline, "no admission wait"
            time.sleep(0.001)
        gate.set()
        producer.join(timeout=60)
        assert not producer.is_alive()
        replies = [f.result(timeout=30) for f in futs]
        assert replies == [{"payload": "ok"}] * 48
        assert ch.stats.admission_waits > 0
        assert stub.agents["Push"].read("k") == 48
        rep = rt.scheduling_report()["MON"]
        assert rep["drained_calls"] == 48
        assert rep["queue_depth"] == 0
        return replies, stub.agents["Push"].read("k"), rep["drained_calls"]
    finally:
        gate.set()
        rt.close()


def test_backpressure_wakeups_with_worker_pool():
    mirror(_wakeups)


# ---- weighted-fair picking (strict tiers + DRR) -----------------------------

def _fake_queue(pk, rt, app, now, **pol_kw):
    ch = rt.controller.register(nf(pk, {"AppName": app, "addTo": "R.kvs"}),
                                n_slots=64)
    q = pk.runtime._ChannelQueue(ch, _policy(pk, **pol_kw), now)
    q.demand = True
    rt._queues[ch.gaid] = q
    return q


def _fill(q, n, now):
    while len(q.entries) < n:
        q.entries.append((None, None, now))


def _priority(pk):
    rt = pk.IncRuntime()
    now = time.monotonic()
    lo = _fake_queue(pk, rt, "P-lo", now, priority=0, weight=100.0)
    hi = _fake_queue(pk, rt, "P-hi", now, priority=3, weight=0.1)
    _fill(lo, 3, now)
    _fill(hi, 3, now)
    picks = []
    with rt._work:
        for _ in range(5):
            q, trigger, take = rt._pick(time.monotonic())
            assert q is hi, "strict priority must beat any weight"
            assert trigger in ("size", "flush") and take == 3
            picks.append((q.channel.netfilter.app_name, trigger, take))
    return picks


def test_pick_prefers_higher_priority_tier():
    mirror(_priority)


def _drr(pk):
    rt = pk.IncRuntime()
    now = time.monotonic()
    heavy = _fake_queue(pk, rt, "W-heavy", now, weight=3.0, max_batch=4)
    light = _fake_queue(pk, rt, "W-light", now, weight=1.0, max_batch=4)
    served = {"W-heavy": 0, "W-light": 0}
    _fill(heavy, 4, now)
    _fill(light, 4, now)
    with rt._work:
        for _ in range(400):
            q, _, take = rt._pick(time.monotonic())
            served[q.channel.netfilter.app_name] += take
            for _ in range(take):
                q.entries.popleft()
            _fill(heavy, 4, now)
            _fill(light, 4, now)
    ratio = served["W-heavy"] / served["W-light"]
    assert 2.0 < ratio < 4.5, served
    assert served["W-light"] > 0
    return served


def test_drr_shares_follow_weights_within_a_tier():
    mirror(_drr)


def _weights(pk):
    rt = pk.IncRuntime()
    now = time.monotonic()
    msgs = []
    for app, w in (("W-bad", 0.0), ("W-nan", float("nan"))):
        with pytest.raises(ValueError, match="weight") as ei:
            _fake_queue(pk, rt, app, now, weight=w)
        msgs.append(str(ei.value))
    return msgs


def test_pick_weight_validation():
    mirror(_weights)


def _debt(pk):
    rt = pk.IncRuntime()
    now = time.monotonic()
    solo = _fake_queue(pk, rt, "W-solo", now, weight=1.0, max_batch=4)
    _fill(solo, 4, now)
    with rt._work:
        for _ in range(100):
            q, _, take = rt._pick(time.monotonic())
            for _ in range(take):
                q.entries.popleft()
            _fill(solo, 4, now)
    floor = -pk.runtime._DEFICIT_CAP_BATCHES * 4 * 1.0
    assert solo.deficit >= floor, solo.deficit
    return solo.deficit, floor


def test_drr_debt_is_bounded_for_a_solo_channel():
    mirror(_debt)


def _reset(pk):
    rt = pk.IncRuntime(policy=_policy(pk, max_batch=4), workers=1)
    try:
        stub = rt.make_stub(monitor_service(pk, "DR-1"))
        futs = [stub.call_async("Push", {"kvs": {"a": 1}})
                for _ in range(8)]
        replies = [f.result(timeout=30) for f in futs]
        with rt._work:
            q = rt._queues[stub.channels["Push"].gaid]
            assert not q.entries
            assert q.deficit == 0.0
            return replies, q.deficit, stub.agents["Push"].read("a")
    finally:
        rt.close()


def test_drr_deficit_resets_when_queue_empties():
    mirror(_reset)


# ---- schema lowering: priority / weight / window knobs ----------------------

def _lowering(pk):
    inc = pk.inc

    @inc.service(app="SW-1")
    class Svc:
        @inc.rpc(request_msg="R", priority=2, weight=3.5,
                 drain=inc.DrainPolicy(max_batch=16, window=4096))
        def Push(self, kvs: inc.Agg[inc.STRINTMap]): ...

    rt = pk.IncRuntime()
    try:
        ch = rt.make_stub(Svc).channels["Push"]
        got = (ch.drain_policy.priority, ch.drain_policy.weight,
               ch.drain_policy.max_batch, ch.server.window)
        assert got == (2, 3.5, 16, 4096)
        return got
    finally:
        rt.close()


def test_schema_priority_weight_and_window_lower_to_channel():
    mirror(_lowering)


def _default_window(pk):
    rt = pk.IncRuntime()
    try:
        window = rt.make_stub(monitor_service(pk, "DW-1")).channels[
            "Push"].server.window
        assert window == 1024
        return window
    finally:
        rt.close()


def test_unannotated_service_keeps_default_agent_window():
    mirror(_default_window)


def _knob_validation(pk):
    inc = pk.inc
    with pytest.raises(inc.SchemaError, match="priority") as e1:
        @inc.service(app="SV-1")
        class Bad1:
            @inc.rpc(priority="high")
            def Push(self, kvs: inc.Agg[inc.STRINTMap]): ...
    with pytest.raises(inc.SchemaError, match="weight") as e2:
        @inc.service(app="SV-2", weight=0)
        class Bad2:
            @inc.rpc
            def Push(self, kvs: inc.Agg[inc.STRINTMap]): ...
    return str(e1.value), str(e2.value)


def test_schema_priority_weight_validation():
    mirror(_knob_validation)


def _bad_window(pk):
    inc = pk.inc

    @inc.service(app="BW-1", drain=inc.DrainPolicy(window=0))
    class Svc:
        @inc.rpc
        def Push(self, kvs: inc.Agg[inc.STRINTMap]): ...

    rt = pk.IncRuntime()
    try:
        with pytest.raises(ValueError, match="window") as ei:
            rt.make_stub(Svc)
        return str(ei.value)
    finally:
        rt.close()


def test_bad_window_override_is_rejected():
    mirror(_bad_window)


# ---- observability ----------------------------------------------------------

def _plane_section(pk):
    rt = pk.IncRuntime(policy=_policy(pk, max_batch=4), workers=2)
    try:
        stub = rt.make_stub(monitor_service(pk, "RPT-1"))
        futs = [stub.call_async("Push", {"kvs": {"a": 1}})
                for _ in range(8)]
        replies = [f.result(timeout=30) for f in futs]
        rep = rt.scheduling_report()
        chan = rep["RPT-1"]
        assert chan["priority"] == 0 and chan["weight"] == 1.0
        assert chan["mean_drain_wait_us"] >= 0.0
        plane = rep["__plane__"]
        assert set(plane["workers"]) == {"w0", "w1"}
        total_drains = sum(w["drains"] for w in plane["workers"].values())
        assert total_drains >= 1
        assert 0 in plane["priorities"]
        assert plane["priorities"][0]["calls"] >= 8
        assert plane["priorities"][0]["mean_wait_us"] >= 0.0
        assert isinstance(plane["pick_contention"], int)
        return (replies, untimed(rep), sorted(plane["workers"]),
                total_drains)
    finally:
        rt.close()


def test_scheduling_report_plane_section():
    mirror(_plane_section)


def _workers_param(pk):
    with pytest.raises(ValueError, match="workers") as ei:
        pk.IncRuntime(workers=0)
    return str(ei.value)


def test_workers_param_validation():
    mirror(_workers_param)


# ---- shutdown: idempotence + no-deadlock stress -----------------------------

def _idempotent(pk):
    rt = pk.IncRuntime(workers=4)
    stub = rt.make_stub(monitor_service(pk, "CL-1"))
    first = stub.call_async("Push", {"kvs": {"a": 1}}).result(timeout=30)
    rt.close()
    rt.close()
    with pytest.raises(RuntimeError, match="closed") as ei:
        stub.call_async("Push", {"kvs": {"a": 1}})
    with pk.IncRuntime(workers=2) as rt2:
        s2 = rt2.make_stub(monitor_service(pk, "CL-2"))
        second = s2.call_async("Push", {"kvs": {"a": 1}}).result(timeout=30)
        assert second == {}
    rt2.close()
    return first, str(ei.value), second


def test_close_is_idempotent():
    mirror(_idempotent)


def _stress(pk):
    rt = pk.IncRuntime(policy=_policy(pk, max_batch=4, max_delay=0.001),
                       workers=4)
    drain_errors = []
    try:
        leaf_svc = pk.Service("Leaf")
        leaf_svc.rpc("LeafPut", [pk.Field("kvs", "STRINTMap")],
                     [pk.Field("msg")],
                     nf(pk, {"AppName": "ST-leaf", "addTo": "R.kvs"}))
        leaf = rt.make_stub(leaf_svc)

        def handler(req):
            mode = req.get("payload")
            if mode == "drain":
                try:
                    rt.drain()
                except RuntimeError as e:
                    drain_errors.append(str(e))
            elif mode == "nest":
                leaf.call("LeafPut", {"kvs": {"n": 1}})
            return {"payload": "ok"}
        rt.server.register("Push", handler)
        stubs = [rt.make_stub(monitor_service(pk, f"ST-{i}"))
                 for i in range(6)]

        def submitter(tid):
            futs = []
            for i in range(60):
                stub = stubs[(tid + i) % len(stubs)]
                mode = ("plain", "drain", "nest")[i % 3]
                futs.append(stub.call_async(
                    "Push", {"kvs": {f"k{tid}": 1}, "payload": mode}))
            for f in futs:
                assert f.result(timeout=60) == {"payload": "ok"}

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(4)]
        deadline = time.monotonic() + 120
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            assert not t.is_alive(), "stress mix deadlocked"
        assert drain_errors and all("deadlock" in e for e in drain_errors)
        assert leaf.agents["LeafPut"].read("n") == 4 * 20
        rt.scheduling_report()
        reads = [[s.agents["Push"].read(f"k{t}") for t in range(4)]
                 for s in stubs]
        return (len(drain_errors), sorted(set(drain_errors)),
                leaf.agents["LeafPut"].read("n"), reads)
    finally:
        rt.close()
        rt.close()


def test_shutdown_stress_handlers_drain_raises_never_hangs():
    mirror(_stress)

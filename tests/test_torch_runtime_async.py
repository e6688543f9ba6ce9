"""The port's auto-drain scheduler and ``IncFuture`` (``core/runtime.py``)
against the JAX package: the 18 tests of ``tests/test_runtime_async.py``
mirrored under their names.

Each body runs once on the reference and once on the port (every runtime
on ``device="cpu"``) through ``_torch_front``; replies, agent reads,
trigger counts and errors must be equal between the two, and each run
asserts what the reference test asserts.

Steadiness. The reference's trigger tests read which trigger fired, and
some of them race the drain thread against the wall clock:
``test_window_trigger_drains_when_window_has_room`` counts a window drain
that becomes a time drain when the worker wakes more than ``max_delay``
(2 ms) after the call. Their mirrors give the runtime a ``ManualClock``:
the time trigger fires when the test moves the clock, never when the host
is slow. The backpressure and timeout tests hold their handler on an
event until the state they assert (an admission wait; a timed-out
``result``) has been reached, instead of a sleep that races the
scheduler.
"""
import threading
import time

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_front import mirror


class ManualClock:
    """A runtime clock that moves only when the test moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def nf(pk, d):
    return pk.NetFilter.from_dict(d)


def monitor_service(pk):
    svc = pk.Service("Monitor")
    svc.rpc("Push", [pk.Field("kvs", "STRINTMap"), pk.Field("payload")],
            [pk.Field("payload")],
            nf(pk, {"AppName": "MON", "addTo": "R.kvs"}))
    svc.rpc("Query", [pk.Field("kvs", "STRINTMap")],
            [pk.Field("kvs", "STRINTMap")],
            nf(pk, {"AppName": "MON", "get": "Y.kvs"}))
    svc.rpc("QueryClear", [pk.Field("kvs", "STRINTMap")],
            [pk.Field("kvs", "STRINTMap")],
            nf(pk, {"AppName": "MON", "get": "Y.kvs", "clear": "copy"}))
    return svc


def wait_done(futs, timeout=30.0):
    """Poll done(), never result() (which would demand-flush and mask
    which trigger fired)."""
    deadline = time.monotonic() + timeout
    while not all(f.done() for f in futs):
        assert time.monotonic() < deadline, "futures never resolved"
        time.sleep(0.002)


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "state never reached"
        time.sleep(0.001)


def slow_policy(pk, **kw):
    kw.setdefault("max_batch", 1000)
    kw.setdefault("max_delay", 30.0)
    kw.setdefault("eager_window", False)
    return pk.DrainPolicy(**kw)


# ---- triggers ---------------------------------------------------------------

def _size(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk, max_batch=4))
    try:
        stub = rt.make_stub(monitor_service(pk))
        futs = [stub.call_async("Push", {"kvs": {"a": 1}}) for _ in range(4)]
        wait_done(futs)
        st_ = stub.channels["Push"].stats
        assert st_.drain_triggers["size"] == 1
        assert st_.drain_triggers["flush"] == 0
        assert st_.drained_batches == 1
        assert st_.mean_drained_batch == 4.0
        assert stub.agents["Push"].read("a") == 4
        return ([f.result() for f in futs], dict(st_.drain_triggers),
                stub.agents["Push"].read("a"))
    finally:
        rt.close()


def test_size_trigger_drains_at_max_batch():
    mirror(_size)


def _time(pk):
    """Three calls at t = 0 under ``max_delay`` 0.05: nothing drains at
    t = 0.04, whatever the worker does; at t = 0.05 the time trigger
    drains them."""
    clock = ManualClock()
    rt = pk.IncRuntime(policy=slow_policy(pk, max_delay=0.05), clock=clock)
    try:
        stub = rt.make_stub(monitor_service(pk))
        futs = [stub.call_async("Push", {"kvs": {"x": 1}}) for _ in range(3)]
        clock.advance(0.04)
        time.sleep(0.1)           # the worker wakes and finds nothing due
        assert not any(f.done() for f in futs)
        clock.advance(0.01)
        wait_done(futs)
        st_ = stub.channels["Push"].stats
        assert st_.drain_triggers["time"] >= 1
        assert st_.drain_triggers["size"] == 0
        assert clock() >= 0.04
        assert stub.agents["Push"].read("x") == 3
        return ([f.result() for f in futs], dict(st_.drain_triggers),
                stub.agents["Push"].read("x"))
    finally:
        rt.close()


def test_time_trigger_bounds_delay():
    mirror(_time)


def _window(pk):
    """The default policy on a clock that never moves: the call is never
    older than ``max_delay``, so only the window trigger can drain it."""
    rt = pk.IncRuntime(clock=ManualClock())
    try:
        stub = rt.make_stub(monitor_service(pk))
        f = stub.call_async("Push", {"kvs": {"w": 1}})
        wait_done([f])
        triggers = dict(stub.channels["Push"].stats.drain_triggers)
        assert triggers["window"] >= 1
        assert triggers["time"] == 0
        return f.result(), triggers, stub.agents["Push"].read("w")
    finally:
        rt.close()


def test_window_trigger_drains_when_window_has_room():
    mirror(_window)


def _backpressure(pk):
    """The reference's slow handler and tiny service rate, with the first
    drain held until a producer has blocked on admission: the producer
    thread fills the backlog (8) while the worker sits in the handler."""
    pol = pk.DrainPolicy(max_batch=8, max_delay=0.001, backlog_factor=1,
                         ecn_threshold=8, service_rate=200.0)
    rt = pk.IncRuntime(policy=pol)
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
        wait_for(lambda: ch.stats.admission_waits > 0)
        gate.set()
        producer.join(timeout=60)
        assert not producer.is_alive()
        replies = [f.result(timeout=30) for f in futs]
        assert replies == [{"payload": "ok"}] * 48
        assert ch.stats.admission_waits > 0
        assert ch.stats.max_queue_depth <= 8 + pol.w_max
        assert stub.agents["Push"].read("k") == 48
        rep = rt.scheduling_report()["MON"]
        assert rep["drained_calls"] == 48
        assert rep["queue_depth"] == 0
        return replies, stub.agents["Push"].read("k"), rep["drained_calls"]
    finally:
        gate.set()
        rt.close()


def test_backpressure_blocks_admission_and_bounds_queue():
    mirror(_backpressure)


# ---- future semantics -------------------------------------------------------

def _fail_handler(req):
    if req.get("payload") == "bad":
        raise RuntimeError("handler down")
    return {"payload": "ok"}


def _abandonment(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk, max_batch=3))
    try:
        rt.server.register("Push", _fail_handler)
        stub = rt.make_stub(monitor_service(pk))
        f1 = stub.call_async("Push", {"kvs": {"a": 1}, "payload": "good"})
        f2 = stub.call_async("Push", {"kvs": {"b": 2}, "payload": "bad"})
        f3 = stub.call_async("Push", {"kvs": {"c": 3}, "payload": "good"})
        r1 = f1.result(timeout=5)
        assert r1 == {"payload": "ok"}
        with pytest.raises(RuntimeError, match="handler down") as e2:
            f2.result(timeout=5)
        with pytest.raises(RuntimeError, match="abandoned") as ei:
            f3.result(timeout=5)
        assert "handler down" in str(ei.value.__cause__)
        assert isinstance(f3.exception(), RuntimeError)
        reads = [stub.agents["Push"].read(k) for k in "abc"]
        assert reads[:2] == [1, 2]
        return r1, str(e2.value), str(ei.value), reads
    finally:
        rt.close(flush=False)


def test_future_exception_and_abandonment():
    mirror(_abandonment)


def _demand(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk))
    try:
        stub = rt.make_stub(monitor_service(pk))
        t0 = time.monotonic()
        f = stub.call_async("Push", {"kvs": {"d": 1}})
        out = f.result(timeout=5)
        assert out == {}
        assert time.monotonic() - t0 < 5.0
        flushes = stub.channels["Push"].stats.drain_triggers["flush"]
        assert flushes >= 1
        return out, flushes
    finally:
        rt.close()


def test_result_demand_flushes_before_time_trigger():
    mirror(_demand)


def _timeout(pk):
    """The handler holds its drain until the short ``result`` has timed
    out: the timeout cannot lose a race with a fast host."""
    rt = pk.IncRuntime(policy=slow_policy(pk))
    gate = threading.Event()
    try:
        rt.server.register(
            "Push", lambda r: (gate.wait(timeout=30), {"payload": "ok"})[1])
        stub = rt.make_stub(monitor_service(pk))
        f = stub.call_async("Push", {"kvs": {"t": 1}, "payload": "p"})
        with pytest.raises(TimeoutError):
            f.result(timeout=0.05)
        gate.set()
        out = f.result(timeout=5)
        assert out == {"payload": "ok"}
        return out
    finally:
        gate.set()
        rt.close()


def test_result_timeout_raises():
    mirror(_timeout)


def _close_leftovers(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk))
    stub = rt.make_stub(monitor_service(pk))
    f = stub.call_async("Push", {"kvs": {"z": 1}})
    rt.close(flush=False)
    with pytest.raises(RuntimeError, match="closed") as e1:
        f.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed") as e2:
        stub.call_async("Push", {"kvs": {"z": 1}})
    return str(e1.value), str(e2.value)


def test_close_resolves_leftovers_and_rejects_new_work():
    mirror(_close_leftovers)


def _drain_sync(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk))
    try:
        stub = rt.make_stub(monitor_service(pk))
        futs = [rt.submit(stub, "Push", {"kvs": {"s": 1}}) for _ in range(5)]
        assert not any(f.done() for f in futs)
        n = rt.drain()
        assert n == 5
        assert all(f.done() for f in futs)
        triggers = dict(stub.channels["Push"].stats.drain_triggers)
        assert triggers["flush"] == 1
        return n, triggers, stub.agents["Push"].read("s")
    finally:
        rt.close()


def test_drain_flushes_everything_synchronously():
    mirror(_drain_sync)


def _trailing_flush(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk, max_batch=2))
    try:
        stub = rt.make_stub(monitor_service(pk))
        ch = stub.channels["Push"]
        boom = RuntimeError("flush exploded")

        def bad_addto(logs, vals):
            raise boom
        ch.server.addto_batch = bad_addto
        f1 = stub.call_async("Push", {"kvs": {"a": 1}})
        f2 = stub.call_async("Push", {"kvs": {"b": 2}})
        r1 = f1.result(timeout=5)
        assert r1 == {}
        with pytest.raises(RuntimeError, match="flush exploded") as ei:
            f2.result(timeout=5)
        return r1, str(ei.value)
    finally:
        rt.close(flush=False)


def test_trailing_flush_failure_surfaces_on_last_future():
    mirror(_trailing_flush)


def _inline_own(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk))
    try:
        stub = rt.make_stub(monitor_service(pk))

        def handler(req):
            if req.get("payload") == "nest":
                inner = stub.call("Query", {"kvs": {"n": 0}})
                return {"payload": f"saw-{int(inner['kvs']['n'])}"}
            return {"payload": "ok"}
        rt.server.register("Push", handler)
        stub.call_async("Push", {"kvs": {"n": 5}, "payload": "plain"})
        out = stub.call("Push", {"kvs": {"n": 2}, "payload": "nest"})
        assert out == {"payload": "saw-7"}
        f = stub.call_async("Push", {"kvs": {"n": 1}, "payload": "nest"})
        out2 = f.result(timeout=5)
        assert out2 == {"payload": "saw-8"}
        assert stub.agents["Push"].read("n") == 8
        return out, out2, stub.agents["Push"].read("n")
    finally:
        rt.close()


def test_handler_inline_call_on_own_channel_does_not_deadlock():
    mirror(_inline_own)


def _nested_clear(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk))
    try:
        stub = rt.make_stub(monitor_service(pk))
        seen = []

        def handler(req):
            if req.get("payload") == "nest":
                out = stub.call("QueryClear", {"kvs": {"k": 0}})
                seen.append(int(out["kvs"]["k"]))
            return {"payload": "ok"}
        rt.server.register("Push", handler)
        stub.call("Push", {"kvs": {"k": 5}, "payload": "plain"})
        f1 = rt.submit(stub, "QueryClear", {"kvs": {"k": 0}})
        rt.submit(stub, "Push", {"kvs": {"z": 1}, "payload": "nest"})
        rt.drain()
        got = f1.result()
        assert got["kvs"]["k"] == 5
        assert seen == [0]
        assert stub.agents["Push"].read("k") == 0
        return got, seen, stub.agents["Push"].read("k")
    finally:
        rt.close()


def test_nested_get_clear_does_not_double_clear():
    mirror(_nested_clear)


def _inline_other(pk):
    svc_b = pk.Service("Other")
    svc_b.rpc("Put", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
              nf(pk, {"AppName": "OTHER", "addTo": "R.kvs"}))
    rt = pk.IncRuntime(policy=slow_policy(pk, max_delay=0.01))
    try:
        sb = rt.make_stub(svc_b)

        def handler(req):
            sb.call("Put", {"kvs": {"x": 1}})
            return {"payload": "ok"}
        rt.server.register("Push", handler)
        sa = rt.make_stub(monitor_service(pk))
        outs = []
        for _ in range(20):
            rt.submit(sb, "Put", {"kvs": {"y": 1}})
            outs.append(sa.call("Push", {"kvs": {"a": 1}, "payload": "p"}))
        assert outs == [{"payload": "ok"}] * 20
        rt.drain()
        reads = [sb.agents["Put"].read(k) for k in "xy"]
        assert reads == [20, 20]
        return outs, reads
    finally:
        rt.close()


def test_handler_inline_call_on_other_channel_does_not_deadlock():
    mirror(_inline_other)


def _drain_in_handler(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk))
    try:
        caught = []

        def handler(req):
            try:
                rt.drain()
            except RuntimeError as e:
                caught.append(str(e))
            return {"payload": "ok"}
        rt.server.register("Push", handler)
        stub = rt.make_stub(monitor_service(pk))
        out = stub.call("Push", {"kvs": {"a": 1}, "payload": "p"})
        assert out == {"payload": "ok"}
        assert caught and "deadlock" in caught[0]
        return out, caught
    finally:
        rt.close()


def test_drain_inside_handler_raises_instead_of_deadlocking():
    mirror(_drain_in_handler)


def _close_raises(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk))
    rt.server.register("Push", lambda r: (_ for _ in ()).throw(
        RuntimeError("handler down")))
    stub = rt.make_stub(monitor_service(pk))
    f = stub.call_async("Push", {"kvs": {"a": 1}, "payload": "p"})
    rt.close()
    with pytest.raises(RuntimeError, match="handler down") as e1:
        f.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed") as e2:
        stub.call_async("Push", {"kvs": {"a": 1}})
    return str(e1.value), str(e2.value)


def test_close_completes_when_flush_raises():
    mirror(_close_raises)


# ---- ordering + stats split -------------------------------------------------

def _inline_first(pk):
    svc = pk.Service("Vote")
    svc.rpc("Cast", [pk.Field("kvs", "STRINTMap")], [pk.Field("msg")],
            nf(pk, {"AppName": "VOTE",
                    "CntFwd": {"to": "SRC", "threshold": 2, "key": "b"}}))
    rt = pk.IncRuntime(policy=slow_policy(pk))
    try:
        rt.server.register("Cast", lambda r: {"msg": "committed"})
        stub = rt.make_stub(svc)
        f = stub.call_async("Cast", {"kvs": {"b1": 1}})
        out = stub.call("Cast", {"kvs": {"b1": 1}})
        queued = f.result(timeout=5)
        assert queued == {}
        assert out == {"msg": "committed"}
        triggers = dict(stub.channels["Cast"].stats.drain_triggers)
        assert triggers["inline"] == 1
        return queued, out, triggers
    finally:
        rt.close()


def test_inline_call_drains_queued_async_calls_first():
    mirror(_inline_first)


def _split(pk):
    rt = pk.IncRuntime(policy=slow_policy(pk, max_batch=4))
    try:
        stub = rt.make_stub(monitor_service(pk))
        for _ in range(6):
            stub.call("Push", {"kvs": {"e": 1}})
        futs = [stub.call_async("Push", {"kvs": {"e": 1}}) for _ in range(4)]
        wait_done(futs)
        st_ = stub.channels["Push"].stats
        assert st_.explicit_batches == 6 and st_.explicit_calls == 6
        assert st_.drained_batches == 1 and st_.drained_calls == 4
        assert st_.mean_explicit_batch == 1.0
        assert st_.mean_drained_batch == 4.0
        assert st_.mean_batch == 10 / 7
        return (st_.explicit_batches, st_.explicit_calls,
                st_.drained_batches, st_.drained_calls, st_.mean_batch,
                stub.agents["Push"].read("e"))
    finally:
        rt.close()


def test_explicit_and_drained_counters_are_split():
    mirror(_split)


# ---- property: async == sequential, in both packages ------------------------

_METHODS = ("Push", "Query", "QueryClear")


def _async_vs_sequential(pk, reqs):
    probe = [f"k{i}" for i in range(8)]
    seq_stub = pk.NetRPC().make_stub(monitor_service(pk))
    want = [seq_stub.call(m, dict(r)) for m, r in reqs]
    want_state = [seq_stub.agents["Push"].read(k) for k in probe]
    rt = pk.IncRuntime(policy=slow_policy(pk, max_batch=3))
    try:
        stub = rt.make_stub(monitor_service(pk))
        futs = [stub.call_async(m, dict(r)) for m, r in reqs]
        got = [f.result(timeout=10) for f in futs]
        got_state = [stub.agents["Push"].read(k) for k in probe]
    finally:
        rt.close()
    assert got == want
    assert got_state == want_state
    return got, got_state


@settings(max_examples=8, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2),
                          st.lists(st.tuples(st.integers(0, 7),
                                             st.integers(-50, 50)),
                                   min_size=1, max_size=4)),
                min_size=1, max_size=12))
def test_async_results_equal_sequential(ops):
    reqs = []
    for mi, kvs in ops:
        method = _METHODS[mi]
        if method == "Push":
            payload = {f"k{ki}": v for ki, v in kvs}
        else:
            payload = {f"k{ki}": 0 for ki, _ in kvs}
        reqs.append((method, {"kvs": payload}))
    mirror(_async_vs_sequential, reqs)


def test_manual_clock_holds_the_time_trigger():
    """The mirrors' clock is the runtime's: with it frozen, a policy whose
    only trigger is time drains nothing until demanded, in both."""
    def body(pk):
        rt = pk.IncRuntime(policy=slow_policy(pk, max_delay=0.001),
                           clock=ManualClock())
        try:
            stub = rt.make_stub(monitor_service(pk))
            f = stub.call_async("Push", {"kvs": {"m": 1}})
            time.sleep(0.05)
            assert not f.done()
            out = f.result(timeout=5)
            triggers = dict(stub.channels["Push"].stats.drain_triggers)
            assert triggers["time"] == 0 and triggers["flush"] == 1
            return out, triggers, np.int64(stub.agents["Push"].read("m"))
        finally:
            rt.close()
    mirror(body)

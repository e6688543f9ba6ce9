"""Client-side local aggregation, ``Agg[...](local_accum=N)``, of the port
against the JAX package.

The 18 tests of ``tests/test_local_accum.py`` are mirrored under their
names: each body runs once on the reference and once on the port (every
runtime on ``device="cpu"``) through ``_torch_front``; replies, reads,
errors and the untimed fields of ``scheduling_report()`` must be equal
between the two, and each run asserts what the reference test asserts.
The device lane (``device=True``) folds through the port's
``ops.device_fold_rounds`` (the plain version of ``fused_fold`` on the
CPU) against the reference's ``fused_fold_pallas`` in interpret mode;
``cuda``-marked twins hold the port's runtime on the card (the hand
kernel) against the same runtime on the CPU, bit for bit.

Steadiness: ``test_staleness_flush_bounds_partial_fold_latency`` gives
the runtime a clock that moves only when the test moves it.
``test_workers4_concurrent_folds_drain_exact`` leaves out the reference's
racy bound on the flushes (its docstring says why) and a new test holds
the fold count where nothing can go stale. That mirror found a fault of
the reference, repaired in the port: a call could pass a fold cohort
another thread had popped but not yet queued
(``test_issue_order_barrier_waits_for_a_popped_fold``).

Three further tests drive the device lane through whole drains: the JAX
``IncRuntime`` and the port's ``IncRuntime(device="cpu")`` over one
register geometry must give bitwise-equal replies, register state and
``ChannelStats``; within each package the folded run must equal the
unfolded ``local_accum=1`` run where no fold saturates. The JAX package
is imported only inside the CPU-lane tests: the card's machine has none.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_front import mirror, port, ref, same, untimed
from repro_torch.core.inc_map import to_jax_state
from repro_torch.kernels import ops

GEOMETRY = (8, 256)


class ManualClock:
    """A runtime clock that moves only when the test moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def kv_service(pk, app, accum, clear="nop"):
    inc = pk.inc

    @inc.service(app=app)
    class KV:
        @inc.rpc
        def Push(self, kvs: inc.Agg[inc.STRINTMap](
            precision=3, local_accum=accum, clear=clear)
        ) -> {"msg": inc.Plain}: ...

        @inc.rpc
        def Query(self, kvs: inc.ReadMostly[inc.STRINTMap](precision=3)): ...
    return KV


def tensor_service(pk, app, accum, device=False, clear="nop", precision=4):
    inc = pk.inc

    @inc.service(app=app)
    class Tensor:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
        def Update(self, tensor: inc.Agg[inc.FPArray](
            precision=precision, device=device, local_accum=accum,
            clear=clear)
        ) -> {"tensor": inc.Get[inc.FPArray]}: ...
    return Tensor


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- schema surface ---------------------------------------------------------

def _off_stream(pk):
    inc = pk.inc
    msgs = []
    for make in (lambda: inc.ReadMostly[inc.STRINTMap](local_accum=4),
                 lambda: inc.Get[inc.FPArray](local_accum=4)):
        with pytest.raises(inc.SchemaError, match="local_accum") as ei:
            make()
        msgs.append(str(ei.value))
    return msgs


def test_local_accum_rejected_off_the_agg_stream():
    mirror(_off_stream)


def _positive(pk, bad):
    inc = pk.inc
    with pytest.raises(inc.SchemaError, match="local_accum") as ei:
        inc.Agg[inc.STRINTMap](local_accum=bad)
    return str(ei.value)


@pytest.mark.parametrize("bad", [0, -1, 2.5, "4", True])
def test_local_accum_must_be_positive_int(bad):
    mirror(_positive, bad)


def _cnt_fwd(pk):
    inc = pk.inc
    with pytest.raises(inc.SchemaError, match="local_accum.*cnt_fwd") as ei:
        @inc.service(app="LA-CF")
        class Svc:
            @inc.rpc(cnt_fwd=inc.CntFwd(to="ALL", threshold=2, key="kvs"))
            def Push(self, kvs: inc.Agg[inc.STRINTMap](local_accum=2)): ...
    return str(ei.value)


def test_local_accum_rejects_cnt_fwd():
    mirror(_cnt_fwd)


def _lazy(pk):
    inc = pk.inc
    with pytest.raises(inc.SchemaError, match="local_accum.*lazy") as ei:
        @inc.service(app="LA-LZ")
        class Svc:
            @inc.rpc
            def Update(self, t: inc.Agg[inc.FPArray](
                    device=True, clear="lazy", local_accum=2)): ...
    return str(ei.value)


def test_local_accum_rejects_lazy_clear():
    mirror(_lazy)


def _accum_methods(pk):
    stub = pk.NetRPC().make_stub(kv_service(pk, "LA-AM", 4))
    assert stub.legacy.accum_methods == {"Push": 4}
    stub1 = pk.NetRPC().make_stub(kv_service(pk, "LA-AM1", 1))
    assert stub1.legacy.accum_methods == {}
    return stub.legacy.accum_methods, stub1.legacy.accum_methods


def test_accum_methods_on_stub():
    mirror(_accum_methods)


# ---- element-exact differential vs the local_accum=1 oracle -----------------

def _kv_rounds(rng, n_rounds, n_keys=12):
    return [{f"k{int(rng.randint(0, n_keys))}":
             round(float(rng.uniform(-50, 50)), 3)
             for _ in range(int(rng.randint(1, 6)))}
            for _ in range(n_rounds)]


def _dict_lane(pk, accum, seed, n_rounds):
    rounds = _kv_rounds(np.random.RandomState(seed), n_rounds)
    keys = sorted({k for r in rounds for k in r})
    outs = []
    for a, app in ((1, f"LA-D1-{seed}-{n_rounds}"),
                   (accum, f"LA-D{accum}-{seed}-{n_rounds}")):
        stub = pk.NetRPC().make_stub(kv_service(pk, app, a))
        for r in rounds:
            stub.Push(kvs=r)
        outs.append(stub.Query(kvs={k: 0 for k in keys}).result()["kvs"])
    assert outs[0] == outs[1]
    return outs


@settings(max_examples=12, deadline=None)
@given(st.sampled_from([2, 8]), st.integers(0, 2**16), st.integers(1, 24))
def test_dict_lane_matches_unfolded_oracle(accum, seed, n_rounds):
    mirror(_dict_lane, accum, seed, n_rounds)


def _tensor_lane(pk, accum, seed, n_rounds, device):
    rng = np.random.RandomState(seed)
    rounds = [(rng.randn(32) * 10).astype(np.float32)
              for _ in range(n_rounds)]
    outs = []
    for a in (1, accum):
        rt = pk.NetRPC()
        stub = rt.make_stub(
            tensor_service(pk, f"LA-T{a}-{seed}-{n_rounds}-{int(device)}",
                           a, device=device), n_slots=64)
        for x in rounds:
            stub.Update(tensor=x)
        rt.drain()
        outs.append(_np(stub.Update(
            tensor=np.zeros(32, np.float32)).result()["tensor"]))
    assert np.array_equal(outs[0], outs[1])
    return outs


@settings(max_examples=10, deadline=None)
@given(st.sampled_from([2, 8]), st.integers(0, 2**16), st.integers(1, 16),
       st.sampled_from([False, True]))
def test_tensor_lane_matches_unfolded_oracle(accum, seed, n_rounds, device):
    mirror(_tensor_lane, accum, seed, n_rounds, device)


def _cohort(pk):
    stub = pk.NetRPC().make_stub(tensor_service(pk, "LA-RP", 3), n_slots=16)
    xs = [np.full(8, float(i + 1), np.float32) for i in range(3)]
    futs = [stub.Update(tensor=x) for x in xs]
    assert all(f.done() for f in futs)
    want = np.asarray(sum(xs))
    got = [_np(f.result()["tensor"]) for f in futs]
    for g in got:
        np.testing.assert_array_equal(g, want)
    return got


def test_cohort_futures_share_the_flush_reply():
    mirror(_cohort)


# ---- clear policies across folded flushes -----------------------------------

def _copy_clear(pk):
    stub = pk.NetRPC().make_stub(
        tensor_service(pk, "LA-CP", 2, clear="copy"), n_slots=16)
    a = stub.Update(tensor=np.full(4, 1.0, np.float32))
    b = stub.Update(tensor=np.full(4, 2.0, np.float32))
    ra, rb = _np(a.result()["tensor"]), _np(b.result()["tensor"])
    np.testing.assert_array_equal(ra, np.full(4, 3.0, np.float32))
    np.testing.assert_array_equal(rb, np.full(4, 3.0, np.float32))
    c = stub.Update(tensor=np.full(4, 5.0, np.float32))
    d = stub.Update(tensor=np.full(4, 6.0, np.float32))
    rd = _np(d.result()["tensor"])
    np.testing.assert_array_equal(rd, np.full(4, 11.0, np.float32))
    assert c.done()
    return ra, rb, _np(c.result()["tensor"]), rd


def test_copy_clear_makes_folded_rounds_independent():
    mirror(_copy_clear)


def _clear_rounds():
    rng = np.random.RandomState(11)
    return [rng.randn(16).astype(np.float32) for _ in range(8)]


def _device_clears(pk, clear, device=None):
    """Every reply of the unfolded and the folded run (the reference
    compares the last ones' shapes; the mirror compares all of them)."""
    replies = []
    for a in (1, 4):
        rt = pk.NetRPC() if device is None else pk.NetRPC(device=device)
        stub = rt.make_stub(
            tensor_service(pk, f"LA-DC{clear}-{a}", a, device=True,
                           clear=clear), n_slots=32)
        replies.append([_np(stub.Update(tensor=x).result()["tensor"])
                        for x in _clear_rounds()])
    assert replies[0][-1].shape == replies[1][-1].shape
    return replies


@pytest.mark.parametrize("clear", ["copy", "shadow"])
def test_device_clears_match_unfolded_oracle(clear):
    mirror(_device_clears, clear)


# ---- future semantics: flush failure chains onto the cohort -----------------

def _flush_failure(pk):
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=64, max_delay=30.0,
                                             eager_window=False))
    try:
        def handler(req):
            raise RuntimeError("handler down")
        rt.server.register("Push", handler)
        stub = rt.make_stub(kv_service(pk, "LA-FC", 3))
        futs = [stub.Push(kvs={"a": i}) for i in range(3)]
        with pytest.raises(RuntimeError, match="handler down") as e0:
            futs[0].result(timeout=10)
        errs = [str(e0.value)]
        for f in futs[1:]:
            with pytest.raises(RuntimeError, match="abandoned") as ei:
                f.result(timeout=10)
            assert "handler down" in str(ei.value.__cause__)
            errs.append(str(ei.value))
        assert stub.agents["Push"].read("a") == 3 * 1000
        return errs, stub.agents["Push"].read("a")
    finally:
        rt.close(flush=False)


def test_flush_failure_chains_abandoned_over_the_cohort():
    mirror(_flush_failure)


def _strands(pk):
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_delay=30.0,
                                             eager_window=False))
    stub = rt.make_stub(kv_service(pk, "LA-CL", 8))
    futs = [stub.Push(kvs={"x": 1}) for _ in range(3)]
    rt.close(flush=False)
    errs = []
    for f in futs:
        with pytest.raises(RuntimeError, match="closed before drain") as ei:
            f.result(timeout=5)
        errs.append(str(ei.value))
    return errs


def test_close_without_flush_strands_folded_futures():
    mirror(_strands)


def _close_flush(pk):
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_delay=30.0,
                                             eager_window=False))
    stub = rt.make_stub(kv_service(pk, "LA-CF2", 8))
    futs = [stub.Push(kvs={"x": 1}) for _ in range(3)]
    rt.close(flush=True)
    got = [f.result(timeout=5) for f in futs]
    assert got == [{}] * 3
    return got, stub.agents["Push"].read("x")


def test_close_with_flush_resolves_folded_futures():
    mirror(_close_flush)


# ---- scheduler integration --------------------------------------------------

def _staleness(pk):
    """A partial fold (1 of 8) created at t = 0 under ``max_delay``
    0.02: the sweep leaves it at t = 0.01 and seals it at t = 0.02; its
    representative, queued at t = 0.02, drains by the time trigger at
    t = 0.04. The test moves the clock only once the sweep has sealed
    the fold (the state it waits on)."""
    clock = ManualClock()
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=64, max_delay=0.02,
                                             eager_window=False),
                       clock=clock)
    try:
        stub = rt.make_stub(kv_service(pk, "LA-ST", 8))
        ch = stub.channels["Push"]
        f = stub.Push(kvs={"x": 1})
        clock.advance(0.01)
        time.sleep(0.05)          # the sweep runs and finds nothing due
        assert not f.done() and ch.folds
        clock.advance(0.01)
        t0 = time.monotonic()
        while ch.folds and time.monotonic() - t0 < 30.0:
            time.sleep(0.005)
        assert not ch.folds, "staleness sweep did not seal the partial fold"
        clock.advance(0.02)
        while not f.done() and time.monotonic() - t0 < 30.0:
            time.sleep(0.005)
        assert f.done(), "staleness sweep did not flush the partial fold"
        st_ = ch.stats
        assert st_.flushes == 1 and st_.local_folds == 1
        assert st_.drain_triggers["time"] == 1
        return f.result(), st_.flushes, st_.local_folds
    finally:
        rt.close()


def test_staleness_flush_bounds_partial_fold_latency():
    mirror(_staleness)


def _demand(pk):
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=64, max_delay=30.0,
                                             eager_window=False))
    try:
        stub = rt.make_stub(kv_service(pk, "LA-DM", 8))
        t0 = time.monotonic()
        f = stub.Push(kvs={"x": 2})
        out = f.result(timeout=10)
        assert out == {}
        assert time.monotonic() - t0 < 10.0
        return out, stub.agents["Push"].read("x")
    finally:
        rt.close()


def test_result_demand_flushes_partial_fold():
    mirror(_demand)


def _window_slot(pk):
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=64, max_delay=30.0,
                                             eager_window=False))
    try:
        stub = rt.make_stub(kv_service(pk, "LA-WS", 8))
        futs = [stub.Push(kvs={"x": 1}) for _ in range(16)]
        rt.drain()
        assert all(f.done() for f in futs)
        rep = rt.scheduling_report()["LA-WS"]
        assert rep["local_folds"] == 16
        assert rep["flushes"] == 2
        assert rep["acks"] == rep["drained_batches"]
        assert rep["drained_calls"] == 2
        assert rep["traffic_reduction"] == pytest.approx(8.0, abs=0.5)
        return [f.result() for f in futs], untimed(rep)
    finally:
        rt.close()


def test_fold_flush_takes_one_window_slot():
    mirror(_window_slot)


def _settled(rt, app: str, calls: int, timeout: float = 10.0) -> dict:
    """The scheduling report once ``app``'s folds account for ``calls``
    calls, or after ``timeout`` s: the reference's call-order barrier
    (``_promote_folds``) does not wait for a fold cohort the staleness
    sweep has popped but not yet queued, so its report, read right after the reads, can miss that
    cohort's calls (``test_report_after_a_read_misses_a_popped_fold``);
    they are flushed a few milliseconds later."""
    deadline = time.monotonic() + timeout
    rep = rt.scheduling_report()
    while rep[app]["local_folds"] < calls and time.monotonic() < deadline:
        rt.drain()
        time.sleep(0.01)
        rep = rt.scheduling_report()
    return rep


def _workers4(pk, max_delay, settle: bool = False):
    """The reference's traffic: 4 producer threads push the same rounds to
    a folded channel and an unfolded oracle, 4 drain workers. Returns the
    two channels' reads and the folded channel's fold counts. ``settle``
    reads the counts once every fold is flushed (``_settled``: the
    reference's), else right after the reads (the port's barrier has
    flushed them all by then)."""
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=16,
                                             max_delay=max_delay),
                       workers=4)
    try:
        folded = rt.make_stub(kv_service(pk, "LA-W4", 4))
        oracle = rt.make_stub(kv_service(pk, "LA-W4o", 1))
        rng = np.random.RandomState(3)
        per_thread = [_kv_rounds(rng, 32) for _ in range(4)]

        def producer(rounds):
            for r in rounds:
                folded.Push(kvs=r)
                oracle.Push(kvs=r)

        threads = [threading.Thread(target=producer, args=(rs,))
                   for rs in per_thread]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rt.drain()
        keys = sorted({k for rs in per_thread for r in rs for k in r})
        probe = {k: 0 for k in keys}
        got = folded.Query(kvs=dict(probe)).result(timeout=30)["kvs"]
        want = oracle.Query(kvs=dict(probe)).result(timeout=30)["kvs"]
        rep = _settled(rt, "LA-W4", 128) if settle \
            else rt.scheduling_report()
        assert rep["LA-W4"]["local_folds"] == 128
        assert 128 // 4 <= rep["LA-W4"]["flushes"] <= 128
        assert rep["LA-W4o"]["local_folds"] == 0
        assert rep["LA-W4o"]["flushes"] == 0
        return got, want, rep["LA-W4"]["local_folds"], rep["LA-W4"]["flushes"]
    finally:
        rt.close()


def test_workers4_concurrent_folds_drain_exact():
    """The reference's 4 producers x 4 workers at ``max_delay`` 1 ms. The
    port's folded reads equal its unfolded oracle's, and both equal the
    reference's oracle. The reference's own folded reads are not held:
    under load they miss whole cohorts (a fault of the reference, shown
    deterministically by ``test_issue_order_barrier_waits_for_a_popped_fold``
    below). Its bound of ``128 // 2`` flushes races too (a producer
    stalled past 1 ms lets the sweep flush a partial fold), so the flushes
    are held to [32, 128] here and counted exactly in the next test. The
    same fault makes the reference's fold count, read right after its
    reads, miss a popped cohort under load (125 of 128 in a stress run of
    the reference alone), so its counts are read once its folds are all
    flushed; the port's are read at once, as before."""
    tp = _workers4(port(), 0.001)
    jx = _workers4(ref(), 0.001, settle=True)
    assert tp[0] == tp[1]
    same(tp[1], jx[1])
    same(tp[0], jx[1])


def test_workers4_concurrent_folds_fold_when_nothing_goes_stale():
    """The same traffic with a 30 s ``max_delay``: every fold seals full,
    128 calls in 32 flushes, in both packages."""
    got = mirror(_workers4, 30.0)
    assert got[0] == got[1]
    assert got[2:] == (128, 32)


def _overtaken(pk):
    """A full fold popped by a producer thread and held before it is
    queued (its dispatch waits on a gate the timer opens 0.2 s later);
    meanwhile the main thread's Query, issued after both folded calls,
    returns what it read."""
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=64, max_delay=30.0,
                                             eager_window=False))
    gate, popped = threading.Event(), threading.Event()
    dispatch = rt._dispatch_fold

    def held(ch, fb):
        popped.set()
        gate.wait(timeout=30)
        dispatch(ch, fb)
    rt._dispatch_fold = held
    try:
        stub = rt.make_stub(kv_service(pk, "LA-BAR", 2))
        producer = threading.Thread(
            target=lambda: [stub.Push(kvs={"x": 1}) for _ in range(2)])
        producer.start()
        assert popped.wait(timeout=30)
        opener = threading.Timer(0.2, gate.set)
        opener.start()
        out = stub.Query(kvs={"x": 0}).result(timeout=30)["kvs"]
        producer.join(timeout=30)
        opener.join()
        return out
    finally:
        gate.set()
        rt.close()


def test_issue_order_barrier_waits_for_a_popped_fold():
    """The fault the workers4 mirror found, made deterministic: between a
    fold buffer's pop and its representative's enqueue, another thread's
    later call could pass it. The reference's Query reads 0 (it passed
    the cohort); the port's issue-order barrier waits for the popped
    cohort and reads both calls."""
    assert _overtaken(port()) == {"x": 2.0}
    assert _overtaken(ref()) == {"x": 0.0}


def _overtaken_report(pk):
    """``_overtaken``'s held fold, and the fold count of the scheduling
    report read right after the Query returned, then once the held fold
    is flushed."""
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=64, max_delay=30.0,
                                             eager_window=False))
    gate, popped = threading.Event(), threading.Event()
    dispatch = rt._dispatch_fold

    def held(ch, fb):
        popped.set()
        gate.wait(timeout=30)
        dispatch(ch, fb)
    rt._dispatch_fold = held
    try:
        stub = rt.make_stub(kv_service(pk, "LA-REP", 2))
        producer = threading.Thread(
            target=lambda: [stub.Push(kvs={"x": 1}) for _ in range(2)])
        producer.start()
        assert popped.wait(timeout=30)
        opener = threading.Timer(0.2, gate.set)
        opener.start()
        stub.Query(kvs={"x": 0}).result(timeout=30)
        at_once = rt.scheduling_report()["LA-REP"]["local_folds"]
        producer.join(timeout=30)
        opener.join()
        return at_once, _settled(rt, "LA-REP", 2)["LA-REP"]["local_folds"]
    finally:
        gate.set()
        rt.close()


def test_report_after_a_read_misses_a_popped_fold():
    """Why the workers4 mirror reads the reference's fold count only once
    its folds are flushed: a report read right after a Query that passed
    a popped cohort counts none of its calls in the reference; the port's
    Query waited for the cohort, so its report counts both at once."""
    assert _overtaken_report(port()) == (2, 2)
    assert _overtaken_report(ref()) == (0, 2)


def test_folds_under_stress_read_every_earlier_call():
    """More producer threads than cores fold into one channel while the
    1 ms staleness sweep seals partial folds and the interpreter switches
    threads every 10 us; after each round the main thread's Query must
    read every call issued before it. The port only: the reference's
    reads can miss a cohort here (queue 3 in ROADMAP.md)."""
    import os
    import sys
    pk = port()
    n_threads = len(os.sched_getaffinity(0)) + 4
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    rt = pk.IncRuntime(policy=pk.DrainPolicy(max_batch=16, max_delay=0.001),
                       workers=4)
    try:
        stub = rt.make_stub(kv_service(pk, "LA-STRESS", 4))
        keys = [f"k{i}" for i in range(4)]
        truth = dict.fromkeys(keys, 0)
        for _ in range(3):
            def producer(t):
                for i in range(8):
                    stub.Push(kvs={keys[(t + i) % 4]: 1})
            threads = [threading.Thread(target=producer, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive(), "a producer never finished"
            for t in range(n_threads):
                for i in range(8):
                    truth[keys[(t + i) % 4]] += 1
            got = stub.Query(kvs=dict.fromkeys(keys, 0)).result(timeout=30)
            assert got["kvs"] == {k: float(v) for k, v in truth.items()}
    finally:
        sys.setswitchinterval(prev)
        rt.close()


def _run_direct(pk):
    stub = pk.NetRPC().make_stub(kv_service(pk, "LA-RD", 8))
    f = stub.Push(kvs={"x": 1})
    out = stub.legacy.call("Query", {"kvs": {"x": 0}})
    assert f.done()
    assert out["kvs"]["x"] == pytest.approx(1.0)
    st_ = stub.channels["Push"].stats
    assert st_.flushes == 1 and st_.local_folds == 1
    return out, st_.flushes, st_.local_folds


def test_run_direct_promotes_open_folds_first():
    mirror(_run_direct)


# ---- the device lane through whole drains, JAX package against the port -----

def _service(inc, app, accum, clear="nop", precision=4):
    # no time trigger: the drain points are the calls' own, so both
    # packages batch alike however slow the interpreter is
    @inc.service(app=app, drain=inc.DrainPolicy(max_batch=64,
                                                max_delay=60.0,
                                                eager_window=False))
    class Tensor:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
        def Update(self, tensor: inc.Agg[inc.FPArray](
                precision=precision, device=True, local_accum=accum,
                clear=clear)
                ) -> {"tensor": inc.Get[inc.FPArray]}: ...
    return Tensor


def _drive(pkg, app, accum, rounds, n_slots, clear="nop", precision=4,
           final_read=True, device="cpu"):
    """Issue every round as an async call, drain, then (optionally) one
    zero call whose reply reads the aggregate. Returns (replies, jax-layout
    switch state, per-app ChannelStats dicts); ``pkg`` is "jax" or
    "torch", the port's switch on ``device``."""
    pk = ref() if pkg == "jax" else port()
    switch = pk.inc_map.SwitchMemory(*GEOMETRY) if pkg == "jax" else \
        pk.inc_map.SwitchMemory(*GEOMETRY, device=device)
    rt = pk.IncRuntime(controller=pk.channel.Controller(switch=switch))
    try:
        stub = rt.make_stub(_service(pk.inc, app, accum, clear, precision),
                            n_slots=n_slots)
        futs = [stub.Update(tensor=x) for x in rounds]
        rt.drain()
        if final_read:
            futs.append(stub.Update(
                tensor=np.zeros_like(rounds[0])))
        replies = [_np(f.result(timeout=60)["tensor"]) for f in futs]
        state = rt.controller.switch.state_dict()
        if pkg == "torch":
            state = to_jax_state(state)
        stats = {ch.netfilter.app_name: dataclasses.asdict(ch.stats)
                 for ch in rt.controller.channels.values()}
        rt.scheduling_report()              # per-channel stats audit
    finally:
        rt.close()
    return replies, state, stats


def _same_run(got, want):
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got[1]["partitions"] == want[1]["partitions"]
    for a, b in zip(got[1]["regs"], want[1]["regs"]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


def _compare(app, accum, rounds, n_slots, **kw):
    ops.reset_counts()
    got = _drive("torch", app, accum, rounds, n_slots, **kw)
    folds = ops.plain_counts()["fused_fold"]
    _same_run(got, _drive("jax", app, accum, rounds, n_slots, **kw))
    return got, folds


LANE_CASES = [(2, 0, 5), (8, 1, 16), (8, 2, 3), (2, 3, 1)]


def _lane_rounds(seed, n_rounds):
    rng = np.random.RandomState(seed)
    return [(rng.randn(32) * 10).astype(np.float32)
            for _ in range(n_rounds)]


@pytest.mark.parametrize("accum,seed,n_rounds", LANE_CASES)
def test_tensor_lane_matches_jax_and_unfolded_oracle(accum, seed, n_rounds):
    rounds = _lane_rounds(seed, n_rounds)
    (replies, _, stats), folds = _compare(
        f"LA-T{accum}-{seed}", accum, rounds, n_slots=64)
    assert folds > 0                      # the fold went through fused_fold
    app_stats = stats[f"LA-T{accum}-{seed}"]
    assert app_stats["local_folds"] >= app_stats["flushes"] > 0
    # the folded aggregate equals the unfolded run's, bit for bit
    unfolded, _, _ = _drive("torch", f"LA-T1-{seed}", 1, rounds, n_slots=64)
    assert replies[-1].tobytes() == unfolded[-1].tobytes()


@pytest.mark.parametrize("clear", ["copy", "shadow"])
def test_device_clears_match_jax(clear):
    rng = np.random.RandomState(11)
    rounds = [rng.randn(16).astype(np.float32) for _ in range(8)]
    (replies, _, stats), folds = _compare(f"LA-DC{clear}", 4, rounds,
                                          n_slots=32, clear=clear,
                                          final_read=False)
    assert folds == 2 and stats[f"LA-DC{clear}"]["flushes"] == 2
    # clear: each flush replies with its own cohort's aggregate
    q = np.rint(np.stack(rounds) * np.float32(1e4)).astype(np.int64)
    inv = np.float32(1) / np.float32(1e4)
    for cohort in range(2):
        want = q[4 * cohort:4 * cohort + 4].sum(0).astype(np.float32) * inv
        for r in replies[4 * cohort:4 * cohort + 4]:
            assert r.tobytes() == want.tobytes()


def _saturating_rounds():
    rng = np.random.RandomState(5)
    rounds = [(rng.randn(24) * 10).astype(np.float32) for _ in range(4)]
    for r in rounds:
        r[:4] = [1.2e5, -1.2e5, 2.0e5, -2.0e5]      # 1.2e9 / 2e9 at 10**4
    return rounds


def test_saturating_fold_matches_jax():
    """Rounds whose fold overflows int32: the device lane saturates in the
    fold (the sticky sentinel of fused_fold_pallas), not the exact int64
    sum of the host lane's fold_rounds, in both packages alike."""
    rounds = _saturating_rounds()
    _, folds = _compare("LA-SAT", 4, rounds, n_slots=32, final_read=False)
    assert folds == 1
    folded = ops.device_fold_rounds(rounds, 10 ** 4, torch.device("cpu"))
    assert folded[:4].tolist() == [2 ** 31 - 1, -(2 ** 31 - 1)] * 2
    exact = ops.fold_rounds([np.rint(r.astype(np.float64) * 1e4)
                             for r in rounds])
    assert abs(int(exact[0])) > 2 ** 31          # the host lane's sum


# ---- the card: the hand kernel under the runtime, against the CPU -----------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("accum,seed,n_rounds", LANE_CASES)
def test_cuda_tensor_lane_matches_cpu(cuda, accum, seed, n_rounds):
    """The device lane's drains on the card (``fused_fold`` and the
    fused addTo/read launched) equal the same drains on the CPU."""
    rounds = _lane_rounds(seed, n_rounds)
    ops.reset_counts()
    got = _drive("torch", f"LA-T{accum}-{seed}", accum, rounds, 64,
                 device=cuda)
    assert ops.launch_counts()["fused_fold"] > 0
    _same_run(got, _drive("torch", f"LA-T{accum}-{seed}", accum, rounds,
                          64))


@pytest.mark.cuda
@pytest.mark.parametrize("clear", ["copy", "shadow"])
def test_cuda_device_clears_match_unfolded_oracle(cuda, clear):
    """``test_device_clears_match_unfolded_oracle``'s runs on the card
    against the same runs on the CPU: every reply, bit for bit. Each
    reply is awaited before the next call, so the folded run flushes one
    call a fold: 8 launches."""
    ops.reset_counts()
    got = _device_clears(port(), clear, device=cuda)
    assert ops.launch_counts()["fused_fold"] == len(_clear_rounds())
    same(got, _device_clears(port(), clear))


@pytest.mark.cuda
def test_cuda_saturating_fold_matches_cpu(cuda):
    """``ops.device_fold_rounds`` on the card saturates as on the CPU."""
    rounds = _saturating_rounds()
    ops.reset_counts()
    got = ops.device_fold_rounds(rounds, 10 ** 4, cuda)
    assert ops.launch_counts()["fused_fold"] == 1
    same(got, ops.device_fold_rounds(rounds, 10 ** 4, torch.device("cpu")))

"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs``: the 20 tests of ``tests/test_obs.py`` mirrored under their
names.

Each body runs once on the reference and once on the port (every runtime
on ``device="cpu"``) through ``_torch_front``, and the two results must
be equal: histogram buckets, counts, sums and quantiles; snapshots and
Prometheus text key for key; trace events by name; the data plane's
replies with obs off and on; the untimed fields of the runtime snapshots
(``_torch_front.untimed``). The port keeps the reference's snapshot
schema string, ``repro.obs/v1``, which ``scripts/obs_schema.json`` pins,
and its ``workers=4`` snapshot validates against that file through
``repro_torch.obs.schema``.
"""
import json
import threading

import pytest

from _torch_front import both, mirror, port, untimed


@pytest.fixture(autouse=True)
def _obs_clean():
    """Both packages' obs start and end every test off and empty."""
    for pk in both():
        pk.obs.disable()
        pk.obs.reset()
    yield
    for pk in both():
        pk.obs.disable()
        pk.obs.reset()


def _hist(h):
    return {"bounds": list(h.bounds), "counts": list(h.counts),
            "count": h.count, "sum": h.sum, "min": h.min, "max": h.max}


# -- histogram arithmetic ----------------------------------------------------

def _boundaries(pk):
    h = pk.metrics.Histogram("h", buckets=(10.0, 20.0, 40.0))
    for v in (5.0, 10.0, 10.5, 20.0, 39.9, 40.0, 41.0):
        h.observe(v)
    assert h.bounds == (10.0, 20.0, 40.0, float("inf"))
    assert h.counts == [2, 2, 2, 1]
    assert h.count == 7
    assert h.sum == pytest.approx(5 + 10 + 10.5 + 20 + 39.9 + 40 + 41)
    assert h.min == 5.0 and h.max == 41.0
    return _hist(h)


def test_histogram_bucket_boundaries():
    mirror(_boundaries)


def _bad_buckets(pk):
    msgs = []
    for b in ((), (1.0, 1.0, 2.0), (2.0, 1.0)):
        with pytest.raises(ValueError) as ei:
            pk.metrics.Histogram("h", buckets=b)
        msgs.append(str(ei.value))
    return msgs


def test_histogram_rejects_bad_buckets():
    mirror(_bad_buckets)


def _observe_many(pk):
    vals = [0.5, 1.0, 3.14, 17.0, 1e4, 2e6, 7.0, 7.0, 0.0]
    a = pk.metrics.Histogram("a")
    b = pk.metrics.Histogram("b")
    for v in vals:
        a.observe(v)
    b.observe_many(vals)
    assert a.counts == b.counts
    assert a.count == b.count
    assert a.sum == pytest.approx(b.sum)
    assert a.min == b.min and a.max == b.max
    b.observe_many([])
    assert b.count == len(vals)
    return _hist(a), _hist(b)


def test_observe_many_equals_observe_loop():
    mirror(_observe_many)


def _merge(pk):
    a = pk.metrics.Histogram("a", buckets=(1.0, 10.0, 100.0))
    b = pk.metrics.Histogram("b", buckets=(1.0, 10.0, 100.0))
    a.observe_many([0.5, 5.0, 50.0])
    b.observe_many([7.0, 500.0])
    a.merge(b)
    assert a.count == 5
    assert a.counts == [1, 2, 1, 1]
    assert a.sum == pytest.approx(562.5)
    assert a.min == 0.5 and a.max == 500.0
    with pytest.raises(ValueError) as ei:
        a.merge(pk.metrics.Histogram("c", buckets=(2.0, 20.0)))
    return _hist(a), str(ei.value)


def test_histogram_merge_exact_and_bound_checked():
    mirror(_merge)


def _clamp(pk):
    H = pk.metrics.Histogram
    h = H("h", buckets=(100.0, 200.0))
    h.observe(150.0)
    qs = [h.quantile(q) for q in (0.0, 0.5, 0.99)]
    assert qs == [150.0] * 3
    h2 = H("h2", buckets=(1.0,))
    h2.observe_many([5.0, 7.0, 9.0])
    assert h2.quantile(0.99) == 9.0
    assert H("h3").quantile(0.5) == 0.0
    with pytest.raises(ValueError) as ei:
        h.quantile(1.5)
    return qs, h2.quantile(0.99), str(ei.value)


def test_quantiles_clamp_to_observed_range():
    mirror(_clamp)


def _monotone(pk):
    h = pk.metrics.Histogram(
        "h", buckets=tuple(float(b) for b in pk.metrics.COUNT_BUCKETS))
    h.observe_many(list(range(1, 1001)))
    qs = [h.quantile(q) for q in (0.1, 0.25, 0.5, 0.75, 0.9, 0.99)]
    assert qs == sorted(qs)
    assert 400 <= h.quantile(0.5) <= 600
    s = h.summary()
    assert set(s) == {"count", "sum", "min", "max", "mean",
                      "p50", "p90", "p99"}
    assert s["count"] == 1000 and s["mean"] == pytest.approx(500.5)
    return qs, s


def test_quantile_interpolates_monotonically():
    mirror(_monotone)


def _concurrent(pk):
    reg = pk.metrics.MetricsRegistry(enabled=True)
    h = reg.histogram("lat_us")
    c = reg.counter("total")
    n_threads, per = 4, 2000

    def work(seed):
        for i in range(per):
            h.observe(float((seed * per + i) % 997))
            c.inc()

    ts = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert h.count == n_threads * per
    assert sum(h.counts) == n_threads * per
    assert c.value == n_threads * per
    return _hist(h), c.value


def test_concurrent_writers_lose_nothing():
    mirror(_concurrent)


# -- registry behavior -------------------------------------------------------

def _dedupe(pk):
    reg = pk.metrics.MetricsRegistry(enabled=True)
    assert reg.counter("x", app="a") is reg.counter("x", app="a")
    assert reg.counter("x", app="a") is not reg.counter("x", app="b")
    with pytest.raises(TypeError) as ei:
        reg.gauge("x", app="a")
    key = pk.metrics.metric_key("x", {"b": 1, "a": 2})
    assert key == 'x{a="2",b="1"}'
    return str(ei.value), key


def test_registry_dedupes_and_type_checks():
    mirror(_dedupe)


def _disabled(pk):
    reg = pk.metrics.MetricsRegistry(enabled=False)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    c.inc()
    g.set(3.0)
    h.observe(1.0)
    h.observe_many([1.0, 2.0])
    off = (c.value, g.value, h.count)
    assert off == (0, 0.0, 0)
    reg.enabled = True
    c.inc(5)
    g.set(2.5)
    h.observe(1.0)
    on = (c.value, g.value, h.count)
    assert on == (5, 2.5, 1)
    return off, on


def test_disabled_registry_records_nothing():
    mirror(_disabled)


def _snapshot(pk):
    reg = pk.metrics.MetricsRegistry(enabled=True)
    reg.counter("c", app="a").inc(3)
    reg.gauge("g").set(1.5)
    reg.histogram("h").observe(10.0)
    reg.register_collector("agents", lambda: {"hits": 7})
    reg.register_collector("broken", lambda: 1 / 0)
    snap = reg.snapshot()
    assert snap["schema"] == "repro.obs/v1" and snap["enabled"]
    assert snap["counters"]['c{app="a"}'] == 3
    assert snap["gauges"]["g"] == 1.5
    assert snap["histograms"]["h"]["count"] == 1
    assert snap["collected"]["agents"] == {"hits": 7}
    assert "error" in snap["collected"]["broken"]
    reg.reset()
    assert reg.snapshot()["counters"] == {}
    return untimed(snap)


def test_snapshot_and_collectors():
    mirror(_snapshot)


def _prometheus(pk):
    reg = pk.metrics.MetricsRegistry(enabled=True)
    reg.counter("reqs", app="a").inc(2)
    h = reg.histogram("lat", buckets=(10.0, 100.0))
    h.observe_many([5.0, 50.0, 500.0])
    text = reg.prometheus_text()
    for line in ("# TYPE lat histogram", 'lat_bucket{le="10.0"} 1',
                 'lat_bucket{le="100.0"} 2', 'lat_bucket{le="+Inf"} 3',
                 "lat_count 3", 'reqs{app="a"} 2'):
        assert line in text, line
    return text


def test_prometheus_text_cumulative_buckets():
    mirror(_prometheus)


# -- trace ring --------------------------------------------------------------

def _events(doc):
    return [{k: e[k] for k in ("name", "ph", "pid", "tid", "ts", "dur")
             if k in e} for e in doc["traceEvents"]]


def _wraparound(pk):
    rec = pk.trace.TraceRecorder(capacity=8)
    for i in range(12):
        rec.add_complete(f"e{i}", "t", float(i), 1.0, tid=1)
    assert len(rec) == 8
    assert rec.dropped == 4
    doc = rec.chrome_trace()
    pk.trace.validate_chrome_trace(doc)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert names == [f"e{i}" for i in range(4, 12)]
    assert doc["otherData"]["dropped_events"] == 4
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0
    return _events(doc), doc["otherData"]


def test_trace_ring_wraparound_counts_drops():
    mirror(_wraparound)


def _stride(pk):
    tm = pk.trace
    pk.obs.enable(trace=True, trace_stride=3)
    sampled = 0
    for _ in range(9):
        ctx = tm.maybe_start("batch", "APP", n=1)
        if ctx is not None:
            sampled += 1
            tm.phase("inner", tm.now_us())
            tm.end(ctx)
    assert sampled == 3
    doc = pk.obs.chrome_trace()
    tm.validate_chrome_trace(doc)
    by_name = {}
    for ev in doc["traceEvents"]:
        by_name[ev["name"]] = by_name.get(ev["name"], 0) + 1
    assert by_name["batch"] == 3 and by_name["inner"] == 3
    return sampled, by_name


def test_trace_sampling_stride_is_deterministic():
    mirror(_stride)


def _noop_spans(pk):
    with pk.obs.trace_span("user"):
        pass
    with pk.trace.span("phase"):
        pass
    off = len(pk.obs.tracer())
    assert off == 0
    pk.obs.enable(trace=True)
    with pk.obs.trace_span("user", step=1):
        pass
    names = [e["name"] for e in pk.obs.chrome_trace()["traceEvents"]]
    assert "user" in names
    return off, names


def test_spans_are_noops_when_off():
    mirror(_noop_spans)


def _garbage(pk):
    msgs = []
    for doc in ({"events": []},
                {"traceEvents": [{"ph": "Z", "pid": 1, "tid": 1}]},
                {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "name": "a",
                                  "ts": 0, "dur": -1}]}):
        with pytest.raises(ValueError) as ei:
            pk.trace.validate_chrome_trace(doc)
        msgs.append(str(ei.value))
    return msgs


def test_validate_chrome_trace_rejects_garbage():
    mirror(_garbage)


# -- strict trigger accounting -------------------------------------------------

def _unknown_trigger(pk):
    st_ = pk.channel.ChannelStats()
    for t in pk.channel.DRAIN_TRIGGERS:
        st_.note_trigger(t)
    assert sum(st_.drain_triggers.values()) == len(pk.channel.DRAIN_TRIGGERS)
    with pytest.raises(ValueError, match="unknown drain trigger") as ei:
        st_.note_trigger("typo")
    return dict(st_.drain_triggers), str(ei.value)


def test_note_trigger_rejects_unknown_trigger():
    mirror(_unknown_trigger)


# -- data-plane integration --------------------------------------------------

def _probe(pk):
    inc = pk.inc

    @inc.service(app="OBS-T", drain=inc.DrainPolicy(
        max_batch=8, max_delay=0.05, eager_window=False))
    class ObsProbe:
        @inc.rpc(request_msg="R")
        def Push(self, kvs: inc.Agg[inc.STRINTMap],
                 payload: inc.Plain) -> {"payload": inc.Plain}: ...

        @inc.rpc(reply_msg="Q")
        def Query(self, kvs: inc.ReadMostly[inc.STRINTMap]): ...
    return ObsProbe


def _workload(pk, n_calls=48):
    rt = pk.NetRPC()
    rt.server.register("Push", lambda req: {"payload": "ack"})
    stub = rt.make_stub(_probe(pk), n_slots=256)
    truth = {}
    replies = []
    for i in range(n_calls):
        kvs = {f"k-{(i * 7 + j) % 13}": j + 1 for j in range(4)}
        for k, v in kvs.items():
            truth[k] = truth.get(k, 0) + v
        replies.append(stub.Push(kvs=kvs, payload=f"p{i}").result())
    query = stub.Query(kvs={k: 0 for k in truth}).result()
    return {"replies": replies, "query": query["kvs"], "truth": truth}


def _identity(pk):
    base = json.dumps(_workload(pk), sort_keys=True)
    pk.obs.enable(trace=True, trace_stride=1)
    traced = json.dumps(_workload(pk), sort_keys=True)
    pk.obs.disable()
    again = json.dumps(_workload(pk), sort_keys=True)
    assert traced == base
    assert again == base
    d = json.loads(base)
    assert d["query"] == d["truth"]
    return base


def test_identity_obs_off_vs_on():
    mirror(_identity)


def _pushed(pk, rt, n, kvs):
    rt.server.register("Push", lambda req: {"payload": "ack"})
    stub = rt.make_stub(_probe(pk), n_slots=256)
    futs = [stub.Push(kvs=kvs(i), payload="x") for i in range(n)]
    rt.drain()
    return [f.result() for f in futs]


def _disabled_snapshot(pk):
    with pk.IncRuntime() as rt:
        replies = _pushed(pk, rt, 16, lambda i: {"a": 1})
        snap = rt.metrics_snapshot()
    assert snap["enabled"] is False
    ch = snap["channels"]["OBS-T"]
    assert "latency_p50_us" not in ch and "drain_wait_p99_us" not in ch
    assert snap["metrics"]["counters"] == {}
    return replies, sorted(ch), snap["metrics"]["counters"]


def test_disabled_runtime_snapshot_has_no_quantiles():
    mirror(_disabled_snapshot)


def _workers4(pk):
    pk.obs.enable(trace=True, trace_stride=2)
    with pk.IncRuntime(workers=4) as rt:
        replies = _pushed(pk, rt, 64,
                          lambda i: {f"k-{i % 11}": 1, f"k-{i % 7}": 2})
        report = rt.scheduling_report()
        snap = rt.metrics_snapshot()
    assert "__switch__" in report
    assert report["__switch__"]["apps"]["OBS-T"]["cache_hit_ratio"] >= 0.0
    pk.obs_schema.validate(snap,
                           pk.obs_schema.load(
                               pk.obs_schema.repo_schema_path()))
    ch = snap["channels"]["OBS-T"]
    for key in ("latency_p50_us", "latency_p99_us",
                "drain_wait_p50_us", "drain_wait_p99_us"):
        assert key in ch, key
    assert ch["latency_p99_us"] >= ch["latency_p50_us"]
    assert ch["acks"] >= 1
    assert snap["switch"]["total_slots"] > 0
    assert snap["switch"]["segments"]
    hists = snap["metrics"]["histograms"]
    assert any(k.startswith("inc_pipeline_pass_us") for k in hists)
    pk.trace.validate_chrome_trace(pk.obs.chrome_trace())
    return (replies, snap["schema"], sorted(snap), sorted(ch),
            untimed(snap["switch"]), untimed(report["__switch__"]))


def test_workers4_snapshot_validates_and_reports_quantiles():
    """The replies, the snapshot's shape (its top keys and a channel's
    keys) and the untimed switch sections (hits, misses, slots,
    segments) are equal in both; the channel's latencies and the split
    of drains over the four workers follow the host."""
    got = mirror(_workers4)
    assert got[1] == "repro.obs/v1"
    assert port().obs_schema.repo_schema_path().name == "obs_schema.json"


def _isolated(pk):
    pk.obs.enable()

    def one_runtime():
        with pk.IncRuntime() as rt:
            _pushed(pk, rt, 8, lambda i: {"a": 1})
            return rt.metrics_snapshot()["channels"]["OBS-T"]

    a = one_runtime()
    b = one_runtime()
    assert a["drained_calls"] == b["drained_calls"] == 8
    return a["drained_calls"], b["drained_calls"]


def test_per_runtime_histograms_are_isolated():
    mirror(_isolated)

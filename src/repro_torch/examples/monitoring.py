"""Network monitoring / flow counting (paper Figs. 22-24, KeyValue type).

Probes increment per-flow counters in the INC map at line rate (the
ElasticSketch analogue); a monitor process queries hot flows at any time.
The cache-replacement policy keeps hot flows on the 'switch' and spills
the long tail to the server agent.

The typed schema declares the whole app: ``MonitorCall`` streams a
``STRINTMap`` through Map.addTo (plus a pass-through payload the server
handler sees), ``Query`` is a ``ReadMostly`` RPC — the request carries
the keys, their aggregated counts come back via Map.get.  The service's
``drain=`` option sets the channel's schedule: every 16 queued probes
become one INC-map kernel batch; application code never schedules (or
drains) anything.  The Query future is issued on the same channel, so
FIFO order guarantees it observes every probe issued before it.

This example also demonstrates the observability front door:
``inc.obs.enable(trace=True)`` turns the data-plane metrics/tracing on,
``inc.metrics()`` records an application-level counter next to the
built-in ones, ``inc.trace(...)`` wraps the probe loop in a user span,
and the run ends with the per-channel p99 latency from
``rt.metrics_snapshot()``.

The switch registers live on the card (every drained batch's addTo is a
launch of the ``sparse_addto`` kernel) unless ``--device cpu``. The
drain's time trigger (``max_delay``) cuts a batch when the host is slow,
so where batches are cut, and with it the 512-slot partition's cache hit
ratio, can move with the host's speed; the counts cannot.

    PYTHONPATH=src python -m repro_torch.examples.monitoring [--device cpu]
"""
import argparse
import sys

import numpy as np

import repro_torch.api as inc
from repro_torch.kernels.backend import resolve_device


@inc.service(app="MON-1",
             drain=inc.DrainPolicy(max_batch=16, max_delay=0.05,
                                   eager_window=False))
class Monitor:
    @inc.rpc(request_msg="MonitorRequest")
    def MonitorCall(self, kvs: inc.Agg[inc.STRINTMap],
                    payload: inc.Plain) -> {"payload": inc.Plain}: ...

    @inc.rpc(reply_msg="QueryReply")
    def Query(self, kvs: inc.ReadMostly[inc.STRINTMap]): ...


def main(argv=None, *, device=None) -> dict:
    """200 zipf probe bursts over 2 000 flows into a 512-slot partition;
    returns the counts and the truth, the hot flows, the partition's
    capacity and cache hit ratio, the channel's scheduling entry, the
    probe counter, the latency quantiles (us) and the trace's length."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=device,
                    help="cuda (the default) or cpu")
    args = ap.parse_args([] if argv is None else argv)

    # no card and no --device cpu: raise before obs (process-wide) is on
    resolve_device(args.device)
    # observability on for the whole run: data-plane metrics + span
    # tracing (every 4th coalesced batch lands on the trace timeline)
    inc.obs.enable(trace=True, trace_stride=4)
    rt = inc.IncRuntime(device=args.device)
    rt.server.register("MonitorCall", lambda req: {"payload": "ack"})
    probe = rt.make_stub(Monitor, n_slots=512)
    probes_sent = inc.metrics().counter("mon_probes_total")

    # synthetic zipf traffic: a few elephant flows, many mice. Probes go
    # through the futures front; the schema's size trigger turns every 16
    # of them into one INC-map kernel batch.
    rng = np.random.RandomState(0)
    truth = {}
    futures = []
    with inc.trace("probe_burst", n=200):
        for _ in range(200):
            flows = rng.zipf(1.4, 64) % 2000
            kvs = {}
            for f in flows:
                key = f"flow-{f}"
                kvs[key] = kvs.get(key, 0) + 1
                truth[key] = truth.get(key, 0) + 1
            probes_sent.inc()
            futures.append(probe.MonitorCall(kvs=kvs, payload="probe"))

    # the monitor reads at any time; the Query rides the same channel
    # queue, so it drains behind all 200 probes (.result() demand-flushes)
    reply = probe.Query(kvs={k: 0 for k in truth}).result()
    assert all(f.result()["payload"] == "ack" for f in futures)
    got = {k: int(v) for k, v in reply["kvs"].items()}
    assert got == truth
    hot = sorted(got.items(), key=lambda kv: -kv[1])[:5]
    srv = probe.agents["MonitorCall"].server
    sched = rt.scheduling_report()["MON-1"]
    print("hot flows:", hot)
    print(f"flows tracked: {len(truth)}; switch slots: {srv.capacity}; "
          f"cache hit ratio: {srv.cache_hit_ratio:.3f}")
    print(f"auto-drain: {sched['drained_calls']} calls in "
          f"{sched['drained_batches']} batches (triggers {sched['drains']}), "
          f"mean batch {sched['mean_drained_batch']}")

    # the obs exports: per-channel latency quantiles + the app counter
    snap = rt.metrics_snapshot()
    mon = snap["channels"]["MON-1"]
    probes = snap["metrics"]["counters"]["mon_probes_total"]
    n_events = len(inc.obs.tracer())
    print(f"obs: {probes} probes; submit->resolve "
          f"p50={mon.get('latency_p50_us', 0.0)}us "
          f"p99={mon.get('latency_p99_us', 0.0)}us; "
          f"CHR={snap['switch']['apps']['MON-1']['cache_hit_ratio']:.3f}; "
          f"{n_events} trace events recorded")
    print("== every counter exact (switch + host-spill fallback)")
    rt.close()
    inc.obs.disable()
    inc.obs.reset()
    return {"counts": got, "truth": truth, "hot": hot,
            "capacity": srv.capacity,
            "cache_hit_ratio": srv.cache_hit_ratio,
            "drained_calls": sched["drained_calls"],
            "drained_batches": sched["drained_batches"],
            "drains": dict(sched["drains"]),
            "mean_drained_batch": sched["mean_drained_batch"],
            "probes": probes,
            "latency_p50_us": mon.get("latency_p50_us", 0.0),
            "latency_p99_us": mon.get("latency_p99_us", 0.0),
            "trace_events": n_events}


if __name__ == "__main__":
    main(sys.argv[1:])

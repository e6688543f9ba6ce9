"""The paper's applications on the port, one module each, run as
``python -m repro_torch.examples.<name>``: ``mapreduce`` (AsyncAgtr),
``monitoring`` (KeyValue), ``paxos`` (Agreement), ``train_telemetry``
(``local_accum`` on a metric stream) and ``train_mini`` (the Fig. 6
convergence run). Each runs on the card unless given ``--device cpu``,
and its ``main`` returns what it asserts and prints.
"""


def hold(name: str, a: dict, b: dict) -> None:
    """Two runs of a runtime example (either package, either device)
    agree, else ``AssertionError``. Held exactly: mapreduce's reduced
    dict and top 5; paxos's one commit a ballot and the learner's
    messages; train_telemetry's sums, mid-run read and folds; monitoring's
    counts (each the truth), hot flows, slots, drained calls and probes.
    What the drain's time trigger moves (monitoring's hit ratio, batches
    and triggers, train_telemetry's flushes) is held only where neither
    run cut a batch by time; each run keeps the example's invariants
    either way."""
    def need(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"{name}: {what}")

    def same(*keys: str) -> None:
        for k in keys:
            need(a[k] == b[k], f"{k} differs: {a[k]!r} vs {b[k]!r}")

    by_time = "drains" in a and bool(a["drains"]["time"]
                                     or b["drains"]["time"])
    if name == "mapreduce":
        same("counts", "top")
    elif name == "paxos":
        for r in (a, b):
            need(r["commits"] == [1] * 50, f"commits {r['commits']}")
            need(r["learned"] == 50, f"learned {r['learned']}")
    elif name == "train_telemetry":
        for r in (a, b):
            need(r["local_folds"] == 32
                 and r["inc_local_folds_total"]
                 == r["local_folds"] - r["flushes"]
                 and 0 < r["flushes"] < 32
                 and r["traffic_reduction"] > 1.5, f"folds {r}")
            need(r["mid"] == {"tokens": 30 * 4096.0}, f"mid {r['mid']}")
        same("sums", *(() if by_time else ("flushes", "traffic_reduction")))
    elif name == "monitoring":
        for r in (a, b):
            need(r["counts"] == r["truth"], "counts differ from the truth")
            need(r["drained_calls"] == 201 and r["probes"] == 200
                 and r["capacity"] == 512,
                 f"calls, probes, slots {r['drained_calls']}, "
                 f"{r['probes']}, {r['capacity']}")
        same("counts", "hot", *(() if by_time else (
            "cache_hit_ratio", "drained_batches", "drains",
            "mean_drained_batch")))
    else:
        raise KeyError(name)

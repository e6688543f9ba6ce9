"""Training telemetry with client-side local aggregation.

A training loop pushes per-step metric scalars through ``TrainTelemetry``;
the metric channel is an ``Agg[STRINTMap]`` stream, so the scalars sum
in-network and a monitor reads them back at any time.  Metrics are
latency-insensitive, which makes them the natural target for
``local_accum=N``: the client folds N pushes into ONE switch-bound update
before they even join the scheduler queue — same exact sums, a fraction
of the pipeline traversals.

What this example demonstrates (and self-asserts):

- ``TrainTelemetry(..., local_accum=4)`` threads the option through the
  typed schema; the step loop needs no change at all.
- Reads stay consistent mid-fold: ``read()`` rides the same channel and
  the promote-before-read barrier flushes any open (partial) fold first,
  so a read after 30 pushes sees all 30 — including the 2 sitting in an
  unsealed fold buffer.
- Exactness: fixed-point quantized sums are element-exact vs the plain
  per-call path (fold math is the same integer addition, done earlier).
- The always-on channel stats (``local_folds``/``flushes``/
  ``traffic_reduction``) and, with obs enabled, the
  ``inc_local_folds_total`` counter of traversals saved.

The switch registers live on the card (every switch update is one launch
of the ``sparse_addto`` kernel) unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_telemetry \\
        [--device cpu]
"""
import argparse
import sys

import repro_torch.api as inc
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.steps import TrainTelemetry

STEPS = 32
ACCUM = 4


def main(argv=None, *, device=None) -> dict:
    """STEPS pushes of three scalars, folded ACCUM at a time; returns the
    sums, the mid-run read, the channel's ``local_folds``, ``flushes``,
    ``traffic_reduction`` and drain triggers, and the
    ``inc_local_folds_total`` counter."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=device,
                    help="cuda (the default) or cpu")
    args = ap.parse_args([] if argv is None else argv)

    # no card and no --device cpu: raise before obs (process-wide) is on
    resolve_device(args.device)
    inc.obs.enable()
    tel = TrainTelemetry(n_workers=1, local_accum=ACCUM, device=args.device)

    # synthetic step loop: three scalars per step, all exact at the metric
    # channel's 3-digit fixed-point precision, so the read-back sums must
    # match the host-side truth to the last digit
    truth = {"loss": 0.0, "lr": 0.0, "tokens": 0.0}
    for step in range(STEPS):
        scalars = {"loss": round(2.5 - 0.05 * step, 3),
                   "lr": 0.001,
                   "tokens": 4096.0}
        for k, v in scalars.items():
            truth[k] += v
        tel.push(scalars)
        if step == STEPS - 3:
            # mid-run read: 30 pushes issued, the last 2 still folding in
            # an unsealed client buffer — the read barrier flushes them
            mid = tel.read(["tokens"])
            assert mid["tokens"] == 30 * 4096.0, mid

    got = tel.read()
    for k, v in truth.items():
        assert abs(got[k] - round(v, 3)) < 1e-9, (k, got[k], v)

    sched = tel.rt.scheduling_report()["train-metrics"]
    folds, flushes = sched["local_folds"], sched["flushes"]
    assert folds == STEPS, sched          # every push was absorbed by a fold
    assert 0 < flushes < STEPS, sched     # ...and folding actually coalesced
    assert sched["traffic_reduction"] > 1.5, sched

    snap = tel.rt.metrics_snapshot()
    saved = snap["metrics"]["counters"].get(
        'inc_local_folds_total{app="train-metrics"}', 0)
    assert saved == folds - flushes, (saved, folds, flushes)

    print(f"{STEPS} metric pushes -> {flushes} switch updates "
          f"(local_accum={ACCUM}, traffic reduction "
          f"{sched['traffic_reduction']}x, {saved} traversals saved)")
    print(f"sums exact at precision=3: loss={got['loss']} lr={got['lr']} "
          f"tokens={got['tokens']}")
    tel.finish()
    inc.obs.disable()
    inc.obs.reset()
    print("== folded telemetry exact; reads consistent mid-fold")
    return {"sums": got, "mid": mid, "local_folds": folds,
            "flushes": flushes,
            "traffic_reduction": sched["traffic_reduction"],
            "inc_local_folds_total": saved, "drains": dict(sched["drains"])}


if __name__ == "__main__":
    main(sys.argv[1:])

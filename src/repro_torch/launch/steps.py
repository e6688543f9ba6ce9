"""The INC telemetry of the train and serve loops: the host half of
``repro/launch/steps.py``.

The loop's metric stream, step-commit quorum and gradient channel run on
the port's async ``IncRuntime`` through typed schema services. The step
builders of the reference (``build_train_step``/``build_serve_step``)
wrap ``shard_map`` over a device mesh; one card has no counterpart, and
they wait for the train step (ROADMAP).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

import repro_torch.api as inc
from repro_torch.api import DrainPolicy, IncFuture, IncRuntime
from repro_torch.obs import hooks as _obs

# fixed-point digits for metric scalars; milli-precision keeps long-run
# accumulated sums far from the int32 saturation sentinels of the register
# path (scaled values must stay << 2**31)
METRIC_PRECISION = 3


def telemetry_service(app: str, local_accum: int = 1):
    """The loop's metric stream as an AsyncAgtr app: per-step scalars ride
    Map.addTo (summed in-network), monitors read them back with Map.get.
    A typed schema class parameterized by AppName (one channel per loop).
    ``local_accum=N`` folds N pushes client-side into one switch-bound
    update (metrics are latency-insensitive, the natural fold target).
    Annotations are assigned explicitly: this module postpones
    annotations, so a closure-parameterized spec inside a decorated class
    body would not resolve."""
    def PushMetrics(self, kvs): ...
    PushMetrics.__annotations__ = {
        "kvs": inc.Agg[inc.STRINTMap](precision=METRIC_PRECISION,
                                      local_accum=local_accum),
        "return": {"msg": inc.Plain}}
    PushMetrics = inc.rpc(request_msg="MetricPush")(PushMetrics)

    def ReadMetrics(self, kvs): ...
    ReadMetrics.__annotations__ = {
        "kvs": inc.ReadMostly[inc.STRINTMap](precision=METRIC_PRECISION)}
    ReadMetrics = inc.rpc(reply_msg="MetricReply")(ReadMetrics)

    cls = type("Telemetry", (), {"PushMetrics": PushMetrics,
                                 "ReadMetrics": ReadMetrics})
    return inc.service(app=app, name="Telemetry")(cls)


# fixed-point digits for gradient elements on the device-resident grad
# channel: micro precision keeps the quantization error below bf16 ULP for
# O(1) gradients while a full dp-group's summed elements stay well under
# the int32 saturation sentinels (n_dp * 1e6 * |g| << 2**31)
GRAD_PRECISION = 6


def gradient_service(app: str):
    """Cross-loop gradient aggregation as a device-resident SyncAgtr app:
    flat fp32 gradient blocks ride Map.addTo (summed in-network through
    the fused quantize+saturating-add kernel on the DeviceSegment
    register file), and every push's Get reply is the running sum as a
    device-resident fp32 tensor (fused gather+dequantize) — gradients
    flow back into the train step without a host round trip. clear="copy"
    makes each aggregation round independent (the reply is the backup)."""
    @inc.service(app=app, name="GradAggregate")
    class GradAggregate:
        @inc.rpc(request_msg="GradPush")
        def PushGrads(self, grads: inc.Agg[inc.FPArray](
                precision=GRAD_PRECISION, clear="copy", device=True)
                ) -> {"grads": inc.Get[inc.FPArray]}: ...
    return GradAggregate


def agreement_service(threshold: int, app: str):
    """Step-commit quorum as an Agreement app: the threshold-th worker vote
    for a step key forwards exactly one commit notification (CntFwd)."""
    @inc.service(app=app, name="StepAgreement")
    class StepAgreement:
        @inc.rpc(cnt_fwd=inc.CntFwd(to="ALL", threshold=threshold,
                                    key="CommitVote.kvs"))
        def CommitStep(self, kvs: inc.STRINTMap) -> {"msg": inc.Plain}: ...
    return StepAgreement


class TrainTelemetry:
    """Metric + agreement channels for the train/serve loops, batched.

    The hot path calls push()/vote(), which enqueue on the async runtime
    through the typed stubs and return immediately: the scheduler
    coalesces many steps' worth of metric pushes into one drained
    pipeline batch (no N=1 INC call ever runs on the step path). read()
    resolves its ReadMetrics future in place; the query rides the same
    channel queue, so FIFO order keeps reads consistent with every push
    issued before them.
    """

    def __init__(self, runtime: IncRuntime | None = None, *,
                 n_workers: int = 1, quorum: float = 1.0,
                 app_prefix: str = "train", grad_slots: int = 0,
                 local_accum: int = 1, device=None):
        # telemetry is latency-insensitive: a generous time trigger lets
        # many steps' pushes coalesce into each drained batch (reads still
        # see everything — the inline ReadMetrics call flushes first).
        # local_accum=N goes further: N metric pushes fold client-side
        # into ONE switch-bound update before they even join the queue
        # (reads stay consistent — the promote-before-read barrier flushes
        # open folds first).
        # ``device`` places an owned runtime's switch: the card unless
        # told "cpu"
        self.rt = runtime or IncRuntime(policy=DrainPolicy(
            max_batch=64, max_delay=0.25, eager_window=False), device=device)
        self._own_rt = runtime is None
        self.threshold = max(1, int(round(quorum * n_workers)))
        self.rt.server.register("CommitStep", self._on_commit)
        self.metrics = self.rt.make_stub(
            telemetry_service(f"{app_prefix}-metrics",
                              local_accum=local_accum))
        self.agree = self.rt.make_stub(
            agreement_service(self.threshold, f"{app_prefix}-agree"))
        # device-resident gradient channel (opt-in by capacity): pushes
        # quantize/aggregate on device, replies are fp32 tensors
        self.grads = None
        if grad_slots:
            self.grads = self.rt.make_stub(
                gradient_service(f"{app_prefix}-grads"), n_slots=grad_slots)
        self._names: set[str] = set()
        # O(1) vote accounting: CntFwd invokes the CommitStep handler
        # exactly once per quorum, inside the (plane-serialized) pipeline
        # pass — so counting there needs no retained futures. Only the
        # most recent vote future is kept: per-channel resolution is FIFO,
        # so once it resolves, every earlier vote's pipeline pass (and its
        # handler-side count) has completed.
        self._commits = 0
        self._last_vote: IncFuture | None = None

    def _on_commit(self, req: dict) -> dict:
        self._commits += 1
        if _obs.METRICS:
            inc.metrics().counter("train_commits_total").inc()
        return {"msg": "commit"}

    def push(self, scalars: dict[str, float]) -> IncFuture:
        """Accumulate metric scalars in-network; returns the push future."""
        self._names.update(scalars)
        kvs = {k: float(v) for k, v in scalars.items()}
        if _obs.METRICS:
            inc.metrics().counter("train_metric_pushes_total").inc()
        return self.metrics.PushMetrics(kvs=kvs)

    def vote(self, step: int) -> IncFuture:
        """Cast this worker's commit vote for ``step``; the future's reply
        is non-empty iff this vote completed the quorum."""
        if _obs.METRICS:
            inc.metrics().counter("train_votes_total").inc()
        f = self.agree.CommitStep(kvs={f"step-{step}": 1})
        self._last_vote = f
        return f

    def push_grads(self, flat_grad) -> IncFuture:
        """Accumulate one flat fp32 gradient block in-network (device
        lane); the reply's ``grads`` is the aggregated block as a
        device-resident fp32 tensor, cleared for the next round."""
        if self.grads is None:
            raise RuntimeError("TrainTelemetry built without grad_slots; "
                               "pass grad_slots=<flat gradient length>")
        if _obs.METRICS:
            reg = inc.metrics()
            n = int(flat_grad.numel() if hasattr(flat_grad, "numel")
                    else len(flat_grad))
            reg.counter("train_grad_pushes_total").inc()
            reg.counter("train_grad_elems_total").inc(n)
            reg.histogram("train_grad_block_elems",
                          buckets=_obs._N).observe(n)
        return self.grads.PushGrads(grads=flat_grad)

    def aggregate_gradients(self, grads):
        """Aggregate a gradient tree (dicts, lists and tuples of tensors)
        through the device channel: leaves flatten into one fp32 block,
        one PushGrads round-trips it through the fused quantize ->
        Map.addTo -> dequantize path, and the reply splits back into the
        tree, on the switch's device. Quantization is GRAD_PRECISION fixed
        point (the SyncAgtr wire format), so values round to 1e-6 like the
        in-network ring would."""
        leaves, spec = tree_flatten(grads)
        flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves])
        out = self.push_grads(flat).result()["grads"]
        parts, pos = [], 0
        for leaf in leaves:
            n = leaf.numel()
            parts.append(out[pos:pos + n].reshape(leaf.shape))
            pos += n
        return tree_unflatten(parts, spec)

    def read(self, names=None) -> dict[str, float]:
        """Read accumulated metrics (queued pushes execute first: the
        read rides the same channel queue, and result() demand-flushes)."""
        keys = {k: 0 for k in (names or sorted(self._names))}
        if not keys:
            return {}
        out = self.metrics.ReadMetrics(kvs=keys).result()
        return {k: float(v) for k, v in out.get("kvs", {}).items()}

    def commits(self) -> int:
        """Quorum notifications among the votes cast so far (waits for the
        last vote, which implies every earlier one resolved)."""
        if self._last_vote is not None:
            self._last_vote.exception()     # block until resolved
        return self._commits

    def finish(self) -> dict:
        """Flush, summarize, and (if owned) stop the runtime. With obs
        metrics enabled the summary carries the full ``repro.obs/v1``
        snapshot (per-channel latency quantiles, registry metrics)."""
        summary = {"metrics": self.read(),
                   "commits": self.commits(),
                   "scheduling": self.rt.scheduling_report()}
        if _obs.METRICS:
            summary["obs"] = self.rt.metrics_snapshot()
        if self._own_rt:
            self.rt.close()
        return summary

"""Train and serve step builders and the INC telemetry of the train and
serve loops: the port of ``repro/launch/steps.py``.

The loop's metric stream, step-commit quorum and gradient channel run on
the port's async ``IncRuntime`` through typed schema services. The train
step is the paper's SyncAgtr pipeline as the gradient aggregation path:

  zero1  params bf16 replicated over dp; local grads accumulate over
         microbatches in fp32; each leaf is INC reduce-scattered along
         its scatter dim (quantize -> per-hop saturating Map.addTo ring
         -> dequant + overflow fallback); AdamW updates this rank's fp32
         chunk (ZeRO-1); the updated leaf is rebuilt by the INC
         all-gather.
  fsdp   params stored dp-scattered (grok-314b, llama-90b); each layer's
         leaves are gathered inside the layer loop by an autograd
         Function whose BACKWARD is the INC reduce-scatter: the paper's
         technique runs inside backprop, per layer. The optimizer
         consumes the already-scattered grads; no re-gather of the full
         model ever materializes.

Serve steps gather params with plain collectives (no gradient stream),
or with the int8 gather (``q8``); decode is either batch-sharded (cache
rows per rank) or sequence-sharded (a batch too small to split: the
partial-softmax combine in ``models/attention.py``).

The reference runs each step as one ``jit(shard_map(...))`` over a mesh,
manual over the data axes and auto over "model", where GSPMD inserts the
tensor-parallel collectives; here it is eager PyTorch, one process a rank
of a ``compat.make_mesh`` mesh (NCCL on the card, gloo with
``device="cpu"``), each holding its shards as plain tensors, and the
model axis' collectives are placed by hand (``sharding/tp.py``,
``Ctx.model``). Tensor parallelism (a "model" axis above 1) runs every
block type (``blocks.TP_BLOCKS``); a config whose cuts do not line up (a
rank's query heads that read more than one KV head, an SSD ``d_inner``
that splits where its heads do not, an RG-LRU width that splits where
its gate blocks do not) raises ``NotImplementedError`` when its step is
built.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

import repro_torch.api as inc
from repro_torch import compat
from repro_torch.api import DrainPolicy, IncFuture, IncRuntime
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import inc_agg
from repro_torch.core.inc_agg import IncAggConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import api
from repro_torch.obs import hooks as _obs
from repro_torch.optim import adamw
from repro_torch.models import rglru
from repro_torch.sharding import rules, tp

SEQ_SHARDED_BLOCKS = ("global", "moe", "selfcross")

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


# ---------------------------------------------------------------------------
# scatter-dim bookkeeping
# ---------------------------------------------------------------------------

def scatter_dims_tree(params, n_dp: int, n_model: int) -> dict[str, int]:
    """{leaf path: the dp-scatter dim of the leaf, -1 if it has none
    (small norms/biases -> psum + replicated opt state)}. ``params`` is a
    ``Tree`` (on any device, the meta device included)."""
    out = {}
    for name, leaf in api.named_leaves(params):
        path = name.split(".")
        t = rules.tp_dim(path, leaf.shape, n_model)
        f = rules.fsdp_dim(path, leaf.shape, n_dp, t)
        out[name] = -1 if f is None else f
    return out


def _with_dp_dim(spec: rules.PartitionSpec, dim: int,
                 dp_axes: tuple[str, ...]) -> rules.PartitionSpec:
    entries = list(spec) + [None] * (dim + 1 - len(spec))
    entries[dim] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return rules.P(*entries)


def opt_specs(pspecs: dict, dims: dict, dp_axes: tuple[str, ...]) -> dict:
    """Optimizer-state partition specs: param spec + dp sharding on the
    scatter dim (fp32 master/m/v, each rank its chunk)."""
    return {k: _with_dp_dim(s, dims[k], dp_axes) if dims[k] >= 0 else s
            for k, s in pspecs.items()}


def _batch_specs(cfg: ArchConfig, shape: ShapeConfig, dp) -> dict:
    """The batch's rows by dp rank (``dp_axes[0]``-major)."""
    dp = dp if len(dp) > 1 else dp[0]
    sp = {"tokens": rules.P(dp)}
    if cfg.family == "vlm":
        sp["patches"] = rules.P(dp)
    if cfg.is_encdec:
        sp["frames"] = rules.P(dp)
    return sp


# ---------------------------------------------------------------------------
# FSDP gather (an autograd Function: backward = the INC reduce-scatter)
# ---------------------------------------------------------------------------

@dataclass
class GradSink:
    """Where the fsdp gathers' backward puts its result: the fp32
    gradient accumulator of each scattered leaf (this rank's chunk shape)
    and the anchor that every gather takes as its differentiable input.

    The reference's gather is a ``custom_vjp`` whose backward returns the
    reduce-scatter's fp32 chunk for a bf16 chunk; JAX keeps that fp32
    cotangent (measured: ``jax.grad`` of a bf16 input through such a
    ``custom_vjp`` under ``scan`` and ``checkpoint`` comes back fp32, not
    rounded to bf16), and its step adds it to the fp32 accumulator as it
    is. PyTorch's engine casts a backward's output to its input's dtype,
    which would round it to bf16. So the backward adds the fp32 chunk to
    the accumulator itself, and autograd reaches every gather through
    the fp32 anchor (a scalar whose gradient is zero)."""
    leaves: dict                 # leaf path -> the stored (chunk) leaf
    acc: dict                    # leaf path -> fp32 accumulator
    anchor: torch.Tensor

    def slot(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The accumulator of ``x``: the leaf's, or its layer's when ``x``
        is one layer of a stacked leaf (found by its storage offset:
        ``_unbind`` takes layer i at i * stride(0))."""
        base, acc = self.leaves[name], self.acc[name]
        if x.shape == base.shape:
            return acc
        i, r = divmod(x.storage_offset() - base.storage_offset(),
                      base.stride(0))
        if r or not 0 <= i < base.shape[0] or \
                x.untyped_storage().data_ptr() != \
                base.untyped_storage().data_ptr():
            raise ValueError(f"{name}: the gathered slice is not a layer "
                             f"of the stored leaf")
        return acc[i]


class _Gather(torch.autograd.Function):
    """The fsdp mode's parameter gather: forward is the INC all-gather
    along ``dim``; backward is the INC reduce-scatter of the gathered
    leaf's cotangent (quantize -> saturating ring -> dequantize: kernels
    7, 6 and 8 on the card), added in fp32 to the step's accumulator
    (``GradSink``). The paper's SyncAgtr inside backprop, per layer."""

    @staticmethod
    def forward(ctx, x, anchor, dim, dp_axes, inc, acc):
        ctx.args = (dim, dp_axes, inc, acc)
        return inc_agg.all_gather_dim(x, dim, dp_axes, inc)

    @staticmethod
    def backward(ctx, ct):
        dim, dp_axes, inc, acc = ctx.args
        acc.add_(inc_agg.reduce_scatter_dim(ct, dim, dp_axes, inc))
        zero = torch.zeros((), dtype=torch.float32, device=ct.device)
        return None, zero, None, None, None, None


def _gather(x, dim: int, name: str, dp_axes, inc: IncAggConfig,
            sink: GradSink) -> torch.Tensor:
    return _Gather.apply(x, sink.anchor, dim, dp_axes, inc,
                         sink.slot(name, x))


def _named_map(tree: dict, fn, prefix: str) -> dict:
    return {k: _named_map(v, fn, f"{prefix}{k}.") if isinstance(v, dict)
            else fn(prefix + k, v) for k, v in tree.items()}


def make_param_gather(dims: dict, dp_axes, inc: IncAggConfig,
                      sink: GradSink):
    """Hook for Ctx.param_gather: gathers one layer of stacked params
    (the slice has lost the stack dim, so scatter dims shift by -1)."""
    def hook(scope: str, gi: int, pslice: dict) -> dict:
        prefix = f"groups.{gi}." if scope == "groups" else "enc.blocks."

        def one(name, leaf):
            d = dims[name]
            if d < 1:      # -1: not scattered; 0 impossible (stack dim)
                return leaf
            return _gather(leaf, d - 1, name, dp_axes, inc, sink)
        return _named_map(pslice, one, prefix)
    return hook


def gather_unstacked(params, dims: dict, dp_axes, inc: IncAggConfig,
                     sink: GradSink):
    """The params as nested dicts, the non-stacked leaves (embed,
    lm_head, final_norm, ...) gathered."""
    def one(name, leaf):
        if dims[name] >= 0 and not rules._is_stacked(name):
            return _gather(leaf, dims[name], name, dp_axes, inc, sink)
        return leaf
    return api.plain_tree(params, one)


# ---------------------------------------------------------------------------
# microbatching
# ---------------------------------------------------------------------------

def default_n_micro(cfg: ArchConfig, shape: ShapeConfig, n_dp: int,
                    budget_bytes: float = 2e9) -> int:
    """Pick n_micro so per-device remat boundary memory fits the budget."""
    local_b = max(shape.global_batch // n_dp, 1)
    per_layer = local_b * shape.seq_len * cfg.d_model * 2
    total = per_layer * (cfg.n_layers + cfg.enc_layers)
    n = 1
    while total / n > budget_bytes and n < local_b:
        n *= 2
    return n


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# the train step's stages, in order
STAGES = ("grads", "aggregate", "update")


class StageClock:
    """Marks at the train step's stage boundaries: CUDA events on the
    card (the stream's time between them, with no synchronize), the host
    clock on the CPU, where every operation finishes before it returns.
    ``ms()`` gives the last step's milliseconds per stage."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: list = []

    def mark(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> dict[str, float]:
        m = self.marks
        if self.device.type == "cuda":
            m[-1].synchronize()
            return {k: m[i].elapsed_time(m[i + 1])
                    for i, k in enumerate(STAGES)}
        return {k: (m[i + 1] - m[i]) * 1e3 for i, k in enumerate(STAGES)}


@dataclass
class Program:
    """A built step: ``fn(params, opt, batch, step)`` and what it was
    built for."""
    fn: Any
    mesh: Any
    meta: dict


def _model_axis(cfg: ArchConfig, mesh, n_model: int):
    """The mesh's "model" axis when it holds more than one rank (tensor
    parallelism), else None. Raises ``NotImplementedError`` where the
    cuts of ``rules.tp_dim`` do not line up: a rank's query heads that
    read more than one KV head (``tp.kv_heads``), an SSD ``d_inner`` or
    an RG-LRU width cut where its heads or gate blocks are not."""
    if n_model == 1:
        return None
    kinds = {bt for pat, _ in cfg.pattern_groups for bt in pat}
    if cfg.n_heads:
        for r in range(n_model):
            tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, n_model, r)

    def splits(n: int) -> bool:
        return n % n_model == 0 and n >= n_model
    rnn = cfg.rnn_width or cfg.d_model
    for bt, width, parts in (
            ("ssd", cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_heads),
            ("rglru", rnn, rglru.N_GATE_BLOCKS if rnn % rglru.N_GATE_BLOCKS
             == 0 else 1)):
        if bt in kinds and splits(width) and not splits(parts):
            raise NotImplementedError(
                f"tensor parallelism over {n_model} ranks: the {bt!r} "
                f"block of {cfg.name} cuts its width of {width} but not its "
                f"{parts} heads or gate blocks")
    return mesh.axes["model"]


def _model_cut(spec: rules.PartitionSpec) -> bool:
    """Whether a leaf of ``spec`` is cut over the "model" axis."""
    return any("model" in rules._entry_axes(e) for e in spec)


def build_train_step(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                     inc: IncAggConfig, opt_cfg: adamw.AdamWConfig,
                     n_micro: int | None = None, mode: str | None = None,
                     flash: bool = False, device=None) -> Program:
    """The train step of ``cfg`` at ``shape`` on ``mesh`` (a
    ``compat.make_mesh`` mesh over ("data", "model") or ("pod", "data",
    "model"), any data and model size), its tensors on ``device`` (the
    card by default). This process is one rank of the mesh; the ranks of one
    data index take the same rows and hold their cuts of the leaves that
    ``rules.tp_dim`` cuts.

    ``prog.fn(params, opt, batch, step)`` -> ``(params, opt, {"loss",
    "gnorm", "lr"})``, the metrics 0-d fp32 tensors. ``batch`` is the
    global batch; the step takes this rank's rows. ``params`` and
    ``opt`` (``{"master", "m", "v"}``) are this rank's shards
    (``init_state``; ``meta["param_specs"]`` and ``meta["opt_specs"]``):
    in zero1 the bf16 params are whole and the fp32 optimizer state is
    this rank's chunk of each scattered leaf; in fsdp the params are
    chunks too, gathered layer by layer inside the forward (and again in
    the checkpoint's recompute), with the INC reduce-scatter as the
    gather's backward. It follows the reference's body step for step.
    Unlike the reference, which returns new trees (and donates the old
    ones), it updates ``params`` and ``opt`` in place and returns them:
    the full-width model's optimizer state is 37 GB, and a second copy
    would not fit the card. ``meta["clock"]`` (a ``StageClock``) times
    the stages of the last step. ``flash`` runs the causal attention
    through the flash kernel and its backward kernels (the reference's
    ``REPRO_FLASH_ATTN=1``), in both modes; by default the plain
    attention."""
    dev = resolve_device(device)
    mode = mode or rules.mode_for(cfg.name)
    if mode not in ("zero1", "fsdp"):
        raise ValueError(f"mode must be 'zero1' or 'fsdp', got {mode!r}")
    names = tuple(a for a in ("pod", "data") if a in mesh.names)
    axes = rules.MeshAxes(data=names)
    n_dp, n_model = axes.sizes(mesh)
    model = _model_axis(cfg, mesh, n_model)
    manual = mesh.axes_of(names)
    if n_micro is None:
        n_micro = default_n_micro(cfg, shape, n_dp)
    if shape.global_batch % n_dp:
        raise ValueError(f"a global batch of {shape.global_batch} does not "
                         f"split over {n_dp} data-parallel ranks")
    local_b = shape.global_batch // n_dp
    if local_b % n_micro:
        raise ValueError(f"a local batch of {local_b} does not split into "
                         f"{n_micro} microbatches")
    shapes = api.param_shapes(cfg)
    dims = scatter_dims_tree(shapes, n_dp, n_model)
    pspecs = rules.param_specs(shapes, axes, mesh, mode)
    ospecs = opt_specs(pspecs, dims, names)
    bspecs = _batch_specs(cfg, shape, names)
    fsdp = mode == "fsdp"
    # the specs name "model" on a leaf's TP dim at any model size
    cut = {name: model is not None and _model_cut(sp)
           for name, sp in pspecs.items()}

    def grads_of(params, leaves, flat_d, mb):
        """fp32 gradient per leaf summed over the microbatches (in fsdp
        a scattered leaf's is already the sum over the ranks, from the
        gathers' backward), and the mean loss over the data-parallel
        ranks."""
        if fsdp:
            gacc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                    if d >= 0 else None
                    for (_, p), d in zip(leaves, flat_d)]
            sink = GradSink({n: p for n, p in leaves},
                            {n: a for (n, _), a in zip(leaves, gacc)
                             if a is not None}, None)
        else:
            gacc = [None] * len(leaves)
        wrt = [j for j, d in enumerate(flat_d) if not (fsdp and d >= 0)]
        for j in wrt:
            leaves[j][1].requires_grad_(True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        try:
            for i in range(n_micro):
                mb_i = {k: v[i] for k, v in mb.items()}
                anchor = []
                if fsdp:
                    sink.anchor = torch.zeros((), dtype=torch.float32,
                                              device=dev, requires_grad=True)
                    anchor = [sink.anchor]
                    loss, _ = api.train_loss(
                        gather_unstacked(params, dims, manual, inc, sink),
                        cfg, mb_i, remat=True,
                        param_gather=make_param_gather(dims, manual, inc,
                                                       sink), model=model,
                        flash=flash)
                else:
                    loss, _ = api.train_loss(params, cfg, mb_i, remat=True,
                                             model=model, flash=flash)
                grads = list(torch.autograd.grad(
                    loss, anchor + [leaves[j][1] for j in wrt],
                    allow_unused=True, materialize_grads=True))[len(anchor):]
                for k, j in enumerate(wrt):
                    # an fp32 buffer per leaf as its bf16 gradient is
                    # freed: 0 + g, then + g of each later microbatch
                    if gacc[j] is None:
                        gacc[j] = torch.zeros(grads[k].shape,
                                              dtype=torch.float32,
                                              device=dev)
                    gacc[j].add_(grads[k])
                    grads[k] = None
                loss_sum = loss_sum + loss.detach()
        finally:
            for j in wrt:
                leaves[j][1].requires_grad_(False)
        loss = inc_agg._psum(loss_sum / torch.full_like(loss_sum, n_micro),
                             manual) / torch.full_like(loss_sum, n_dp)
        return gacc, loss

    def aggregate(gacc, flat_d, flat_cut):
        """Each leaf's mean over the ranks: INC reduce-scattered along its
        scatter dim (in fsdp already reduced by the gathers' backward),
        or summed where it has none. The global norm sums the squares of
        a scattered chunk over the data axes and, for a leaf cut over
        "model", of every leaf over the model axis too; a leaf whole over
        "model" is the same on each of its ranks and counts once."""
        inv = 1.0 / (n_micro * n_dp)
        agg = []
        for j, d in enumerate(flat_d):
            g, gacc[j] = gacc[j], None
            if fsdp and d >= 0:
                agg.append(g.mul_(inv))      # scattered+summed in backward
            elif d >= 0:
                agg.append(inc_agg.reduce_scatter_dim(g, d, manual, inc)
                           .mul_(inv))
            else:
                agg.append(inc_agg._psum(g, manual).mul_(inv))
            del g
        sq = {(s, c): torch.zeros((), dtype=torch.float32, device=dev)
              for s in (True, False) for c in (True, False)}
        for g, d, c in zip(agg, flat_d, flat_cut):
            sq[(d >= 0, c)] = sq[(d >= 0, c)] + torch.sum(torch.square(g))
        sq_scat, sq_repl = sq[(True, False)], sq[(False, False)]
        if model is not None:
            over = inc_agg._psum(torch.stack([sq[(True, True)],
                                              sq[(False, True)]]), (model,))
            sq_scat, sq_repl = sq_scat + over[0], sq_repl + over[1]
        gnorm = torch.sqrt(inc_agg._psum(sq_scat, manual) + sq_repl)
        return agg, gnorm

    def update(opt, leaves, flat_d, agg, factor, lr, step):
        """AdamW on each leaf's chunk, then in zero1 the bf16 leaf rebuilt
        by the INC all-gather (in fsdp the chunk is the stored leaf), in
        place."""
        state = {k: dict(opt[k].named_parameters())
                 for k in ("master", "m", "v")}
        for j, ((name, p), d) in enumerate(zip(leaves, flat_d)):
            g, agg[j] = agg[j], None
            ms = state["master"][name]
            st = adamw.adamw_leaf(
                {k: state[k][name] for k in state}, g.mul_(factor), lr=lr,
                cfg=opt_cfg, step=step, wd_on=adamw.decay_mask(ms))
            del g
            upd = st["master"].to(p.dtype)
            if d >= 0 and not fsdp:
                upd = inc_agg.all_gather_dim(upd, d, manual, inc)
            p.data.copy_(upd)
            del upd

    clock = StageClock(dev)

    def fn(params, opt, batch, step):
        clock.marks = []
        leaves = api.named_leaves(params)
        flat_d = [dims[name] for name, _ in leaves]
        flat_cut = [cut[name] for name, _ in leaves]
        # every input (the tokens, and whisper's frames or a VLM's
        # patches): this rank's rows of the global batch, split into the
        # microbatches along the batch dim
        mb = {}
        for k, v in batch.items():
            if v.shape[0] != shape.global_batch:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not "
                                 f"the global batch of {shape.global_batch}")
            v = rules.shard_of(v, bspecs[k], mesh).to(dev)
            mb[k] = v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
        clock.mark()
        gacc, loss = grads_of(params, leaves, flat_d, mb)   # local grads
        clock.mark()
        agg, gnorm = aggregate(gacc, flat_d, flat_cut)   # INC aggregation
        clock.mark()
        factor = adamw.clip_factor(gnorm, opt_cfg.grad_clip)
        lr = adamw.schedule(opt_cfg, step, device=dev)
        update(opt, leaves, flat_d, agg, factor, lr, step)   # AdamW
        clock.mark()
        return params, opt, {"loss": loss, "gnorm": gnorm, "lr": lr}

    meta = {"mode": mode, "n_micro": n_micro, "n_dp": n_dp,
            "n_model": n_model, "manual": names, "kind": "train",
            "flash": flash,
            "dims": dims, "param_specs": pspecs, "opt_specs": ospecs,
            "device": dev, "clock": clock}
    return Program(fn=fn, mesh=mesh, meta=meta)


def state_specs(program: Program) -> dict:
    """The specs of a train program's state as ``CheckpointStore`` takes
    them: {"params": param specs, "opt": {"master", "m", "v": opt
    specs}}."""
    o = program.meta["opt_specs"]
    return {"params": program.meta["param_specs"],
            "opt": {"master": o, "m": o, "v": o}}


def init_state(program: Program, cfg: ArchConfig, seed: int = 0):
    """Random params from ``seed`` and a fresh optimizer state (fp32
    master copies, zero m and v) on the program's device: every rank
    draws the full params from the same seed, then keeps its shards."""
    full = api.init_params(seed, cfg, device=program.meta["device"])
    opt = init_opt(full, program.meta["opt_specs"], program.mesh)
    return api.shard_tree(full, program.meta["param_specs"],
                          program.mesh), opt


def init_opt(params, specs: dict | None = None, mesh=None) -> dict:
    """AdamW state for the full ``params``: an fp32 master copy, zero m
    and v; with ``specs`` ({leaf path: PartitionSpec}) and ``mesh``, this
    rank's shard of each."""
    def shard(name, t):
        return t if specs is None else rules.shard_of(t, specs[name], mesh)

    def master(name, t):
        return shard(name, t.detach()).to(torch.float32, copy=True)

    def zeros(name, t):
        return torch.zeros(shard(name, t.detach()).shape,
                           dtype=torch.float32, device=t.device)
    return {"master": api.map_named(master, params),
            "m": api.map_named(zeros, params),
            "v": api.map_named(zeros, params)}


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def _cache_manual_specs(cfg: ArchConfig, shape: ShapeConfig,
                        dp: tuple[str, ...], seq_sharded: bool,
                        n_model: int = 1):
    """(the cache at the global shape as meta tensors, its specs: the same
    tree of PartitionSpecs). Batch-sharded, every leaf's rows (dim 1,
    after the layer dim) go by data rank; sequence-sharded, the K/V of
    ``SEQ_SHARDED_BLOCKS`` are cut along the sequence (dim 2) and the rest
    (local rings, recurrent states, a memory's K/V) is whole on every
    rank. Over a model axis above 1, as in the reference, the K/V heads
    (dim 3) are cut over "model" when they split, and a recurrent state's
    dim 2 (the SSD heads, the RG-LRU width) when it splits; the conv
    tails stay whole. When the KV heads do not split, the reference cuts
    ``head_dim``; the port keeps on each rank, whole, the KV heads its
    query heads read (``tp.kv_heads``, which ``shard_cache`` takes: no
    spec entry says it; ROADMAP, queue 3)."""
    cspecs = api.cache_specs(cfg, shape.global_batch, shape.seq_len)
    dp = dp if len(dp) > 1 else dp[0]

    def spec(bt: str, key: str, leaf: torch.Tensor):
        if not seq_sharded:
            entries = [None, dp]
        elif bt in SEQ_SHARDED_BLOCKS and key in ("k", "v"):
            entries = [None, None, dp]
        else:
            entries = []
        dim = {"k": 3, "v": 3, "mk": 3, "mv": 3, "state": 2}.get(key)
        if n_model > 1 and dim is not None \
                and leaf.shape[dim] % n_model == 0 \
                and leaf.shape[dim] >= n_model:
            entries += [None] * (dim - len(entries)) + ["model"]
        return rules.P(*entries)
    specs = tuple({s: {k: spec(pat[int(s[1:])], k, t) for k, t in e.items()}
                   for s, e in g.items()}
                  for (pat, _), g in zip(cfg.pattern_groups, cspecs))
    return cspecs, specs


def shard_cache(cache: tuple, program: Program) -> tuple:
    """This rank's shard of a full decode cache under the program's
    ``meta["cache_specs"]`` (``rules.shard_of``: a leaf that is not cut is
    the caller's tensor, which the decode then writes in place); over a
    model axis whose cut the specs do not say, the K/V (the memory's too)
    keep the rank's ``meta["kv_heads"]`` (first, count)."""
    specs, mesh = program.meta["cache_specs"], program.mesh
    first, count = program.meta["kv_heads"]

    def one(key, t, spec):
        t = rules.shard_of(t, spec, mesh)
        if key not in ("k", "v", "mk", "mv") or _model_cut(spec) \
                or count == t.shape[3]:
            return t
        return t.narrow(3, first, count).clone(
            memory_format=torch.contiguous_format)
    return tuple({s: {k: one(k, t, sg[s][k]) for k, t in e.items()}
                  for s, e in g.items()} for g, sg in zip(cache, specs))


def build_serve_step(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                     mode: str | None = None, q8: bool = False,
                     flash: bool = True, device=None) -> Program:
    """The prefill or decode program of ``cfg`` (``shape.kind``) on
    ``mesh`` (data and model axes of any size), its tensors on
    ``device`` (the card by default). This process is one rank of the mesh;
    ``params`` are this rank's shards under ``meta["param_specs"]`` (in
    fsdp the scattered leaves are chunks: the non-stacked ones are
    gathered whole at each call, each layer's inside the layer loop;
    over "model" the leaves that ``rules.tp_dim`` cuts are this rank's
    cut, and the cache holds the rank's ``meta["kv_heads"]`` and its cut
    of the recurrent states; the conv tails are whole).
    The gather is ``all_gather_dim`` (the leaf itself when the data axes
    hold one rank, where the reference's XLA drops it), or with ``q8``
    the int8 ``all_gather_dim_q8``, which quantizes at one rank too (the
    reference's ``REPRO_QUANTIZED_GATHER=1``). ``flash`` routes the
    prefill's causal attention through kernel 11.

      prefill  ``prog.fn(params, batch)``: ``batch`` is the global batch
               (tokens (B, S), and the frames or patches), of which the
               step takes this rank's rows; returns (logits (B, V) on
               every rank, this rank's cache shard: its rows at S).
      decode   ``prog.fn(params, token, pos, cache)``: ``token`` (B,) is
               the global batch's, ``cache`` this rank's shard under
               ``meta["cache_specs"]`` (``shard_cache``), written in
               place; returns (logits (B, V) on every rank, the cache).
               Batch-sharded when B splits over the data ranks (the
               logits are then gathered over them), else
               sequence-sharded (``meta["seq_sharded"]``): the global
               K/V's positions are cut over the data ranks, the first
               axis major, and attention combines the ranks' partial
               softmaxes; the rest of the step runs whole on every
               rank."""
    dev = resolve_device(device)
    mode = mode or rules.mode_for(cfg.name)
    if mode not in ("zero1", "fsdp"):
        raise ValueError(f"mode must be 'zero1' or 'fsdp', got {mode!r}")
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"a serve step is a prefill or a decode, not "
                         f"{shape.kind!r}")
    names = tuple(a for a in ("pod", "data") if a in mesh.names)
    axes = rules.MeshAxes(data=names)
    n_dp, n_model = axes.sizes(mesh)
    model = _model_axis(cfg, mesh, n_model)
    kv_heads = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, n_model,
                           0 if model is None else compat.axis_index(model))
    seq_sharded = shape.global_batch % n_dp != 0
    if seq_sharded and shape.kind == "prefill":
        raise ValueError(f"a prefill batch of {shape.global_batch} does not "
                         f"split over {n_dp} data-parallel ranks")
    if seq_sharded and shape.seq_len % n_dp and any(
            bt in SEQ_SHARDED_BLOCKS for pat, _ in cfg.pattern_groups
            for bt in pat):
        raise ValueError(f"a sequence-sharded cache of {shape.seq_len} "
                         f"positions does not split over {n_dp} "
                         f"data-parallel ranks")
    manual = mesh.axes_of(names)
    shapes = api.param_shapes(cfg)
    dims = scatter_dims_tree(shapes, n_dp, n_model)
    pspecs = rules.param_specs(shapes, axes, mesh, mode)
    _, cspecs = _cache_manual_specs(cfg, shape, names, seq_sharded, n_model)
    serve_inc = IncAggConfig(mode="xla-psum")
    fsdp = mode == "fsdp"

    def gather_leaf(name, leaf, d):
        if q8:
            cut = model is not None and _model_cut(pspecs[name])
            return inc_agg.all_gather_dim_q8(leaf, d, manual,
                                             model if cut else None)
        if n_dp == 1:
            return leaf
        return inc_agg.all_gather_dim(leaf, d, manual, serve_inc)

    def hook(scope: str, gi: int, pslice: dict) -> dict:
        """One layer of stacked params gathered (the slice has lost the
        stack dim, so scatter dims shift by -1)."""
        prefix = f"groups.{gi}." if scope == "groups" else "enc.blocks."
        return _named_map(pslice, lambda name, leaf: gather_leaf(
            name, leaf, dims[name] - 1) if dims[name] >= 1 else leaf, prefix)

    def prep(params):
        """The params with the non-stacked scattered leaves gathered (in
        fsdp; zero1's params are whole)."""
        if not fsdp:
            return params
        return api.plain_tree(params, lambda name, leaf: gather_leaf(
            name, leaf, dims[name]) if dims[name] >= 0
            and not rules._is_stacked(name) else leaf)

    gather = hook if fsdp else None

    def rows(x: torch.Tensor) -> torch.Tensor:
        """(B/n_dp, ...) of every rank -> (B, ...), data rank major."""
        return x if n_dp == 1 else inc_agg.all_gather_dim(x, 0, manual,
                                                          serve_inc)

    def check_rows(name: str, x: torch.Tensor) -> None:
        if x.shape[0] != shape.global_batch:
            raise ValueError(f"{name} has {x.shape[0]} rows, not the global "
                             f"batch of {shape.global_batch}")

    meta = {"mode": mode, "kind": shape.kind, "n_dp": n_dp,
            "n_model": n_model, "manual": names, "param_specs": pspecs,
            "cache_specs": cspecs, "seq_sharded": seq_sharded,
            "kv_heads": kv_heads}
    if shape.kind == "prefill":
        bspecs = _batch_specs(cfg, shape, names)

        def prefill_fn(params, batch: dict):
            local = {}
            for k, v in batch.items():
                check_rows(f"batch[{k!r}]", v)
                local[k] = rules.shard_of(v, bspecs[k], mesh).to(dev)
            logits, cache = api.prefill(prep(params), cfg, local,
                                        flash=flash, param_gather=gather,
                                        model=model)
            return rows(logits), cache
        return Program(fn=prefill_fn, mesh=mesh, meta=meta)

    tok_spec = rules.P() if seq_sharded else _batch_specs(
        cfg, shape, names)["tokens"]
    seq_axes = manual if seq_sharded else None

    def decode_fn(params, token: torch.Tensor, pos: int, cache: tuple):
        check_rows("token", token)
        tok = rules.shard_of(token, tok_spec, mesh).to(dev)
        logits, cache = api.decode_step(prep(params), cfg, tok, pos, cache,
                                        seq_axes=seq_axes,
                                        param_gather=gather, model=model)
        return (logits if seq_sharded else rows(logits)), cache
    return Program(fn=decode_fn, mesh=mesh, meta=meta)

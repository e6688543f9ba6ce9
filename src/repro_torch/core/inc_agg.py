"""The INC gradient-aggregation service (SyncAgtr path, paper §4-§5).

Modes:

  xla-psum   the collective library's fp32 all-reduce — the pure software
             baseline ("BytePS" in the paper's Fig. 6); the name is the
             JAX package's, where it is XLA's psum.
  fp32-ring  our ring all-reduce in fp32 — isolates the ring
             implementation from quantization effects.
  netrpc     PAPER-FAITHFUL: quantize to int32 fixed point (Precision=p),
             ring reduce-scatter where each hop is the switch's saturating
             Map.addTo, overflow-sentinel fallback re-reduction in fp32
             (the "server agent" path), dequantize.
  netrpc-opt BEYOND-PAPER: per-128-block shared-scale int8 quantization
             carried as int16 partial sums on the wire (2 B/elem vs 4),
             with a *static* no-overflow guarantee (127 * n_dp <= 32767)
             replacing the dynamic fallback entirely.

This is the JAX package's ``core/inc_agg.py``: the flat-buffer API and
the per-leaf API of the train step.
Every process is one data-parallel rank; ``dp_axes`` are mesh axes of
``compat.make_mesh``. JAX's collectives map onto ``torch.distributed``:
``psum`` is ``all_reduce(SUM)`` and ``pmax`` is ``all_reduce(MAX)`` over
each axis' group; ``psum_scatter`` is ``reduce_scatter_tensor`` on NCCL
and, since gloo has none, an all-reduce followed by the owned chunk on
gloo (the same values); ``all_gather`` is ``dist.all_gather``.

Every mode returns the SUM over DP ranks; callers fold the 1/n mean into the
optimizer or the dequant scale.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import reduce

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.compat import Axis
from repro_torch.core import ring
from repro_torch.core.quantize import dequantize, quantize
from repro_torch.kernels import ops

MODES = ("xla-psum", "fp32-ring", "netrpc", "netrpc-opt")
_INT16_MAX = 32767
_BLOCK = 128  # shared-scale block size (one TPU lane row in the reference)


@dataclass(frozen=True)
class IncAggConfig:
    mode: str = "netrpc"
    precision: int = 8          # NetFilter Precision: scale = 10**p
    n_streams: int = 1          # concurrent flows (paper's auto DP)
    fallback: str = "always"    # "always" | "none" (netrpc mode only)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got "
                             f"{self.mode!r}")
        if self.fallback not in ("always", "none"):
            raise ValueError(f"fallback must be 'always' or 'none', got "
                             f"{self.fallback!r}")


def dp_size(dp_axes: tuple[Axis, ...]) -> int:
    n = 1
    for ax in dp_axes:
        n = n * compat.axis_size(ax)
    return n


def pad_multiple(dp_sizes: tuple[int, ...], n_streams: int = 1) -> int:
    """Bucket lengths must divide by this so every RS level chunks evenly."""
    return int(reduce(lambda a, b: a * b, dp_sizes, 1)) * n_streams * _BLOCK


def _split_streams(g: torch.Tensor, n_streams: int) -> list[torch.Tensor]:
    if n_streams == 1:
        return [g]
    L = g.shape[0]
    if L % n_streams:
        raise ValueError(f"length {L} does not divide into {n_streams} "
                         f"streams")
    c = L // n_streams
    return [g[i * c:(i + 1) * c] for i in range(n_streams)]


# -- the collectives of the JAX package, per mesh axis -----------------------

def _psum(x: torch.Tensor, dp_axes: tuple[Axis, ...]) -> torch.Tensor:
    x = x.clone()
    for ax in dp_axes:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ax.group)
    return x


def _pmax(x: torch.Tensor, dp_axes: tuple[Axis, ...]) -> torch.Tensor:
    x = x.clone()
    for ax in dp_axes:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=ax.group)
    return x


def _psum_scatter(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Tiled psum_scatter along dim 0: rank j of the axis gets the sum of
    chunk j. A reduce-scatter where the backend has one (NCCL, and the dry
    run's fake backend, which stands for NCCL)."""
    n = compat.axis_size(ax)
    c = x.shape[0] // n
    if dist.get_backend(ax.group) != "gloo":
        out = torch.empty((c,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=ax.group)
        return out
    j = compat.axis_index(ax)
    return _psum(x, (ax,))[j * c:(j + 1) * c]


def _all_gather_tiled(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(compat.axis_size(ax))]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# full all-reduce API (simple-DP training, microbenchmarks, examples)
# ---------------------------------------------------------------------------

def all_reduce(g: torch.Tensor, dp_axes: tuple[Axis, ...], cfg: IncAggConfig
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Aggregate a flat fp32 buffer over the DP axes. Returns (sum,
    overflow mask)."""
    outs, masks = [], []
    for s in _split_streams(g, cfg.n_streams):
        o, m = _all_reduce_one(s, dp_axes, cfg)
        outs.append(o)
        masks.append(m)
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    mask = None if masks[0] is None else (
        masks[0] if len(masks) == 1 else torch.cat(masks))
    return out, mask


def _all_reduce_one(g, dp_axes, cfg):
    if cfg.mode == "xla-psum":
        return _psum(g, dp_axes), None
    if cfg.mode == "fp32-ring":
        return ring.fp32_ring_all_reduce(g, dp_axes), None
    if cfg.mode == "netrpc":
        q = quantize(g, cfg.precision)
        r = ring.sat_ring_all_reduce(q, dp_axes)
        x, mask = dequantize(r, cfg.precision)
        if cfg.fallback == "always":
            repaired = _psum(torch.where(mask, g, torch.zeros_like(g)),
                             dp_axes)
            x = torch.where(mask, repaired, x)
        return x, mask
    if cfg.mode == "netrpc-opt":
        q16, scale = _opt_encode(g, dp_axes)
        r = ring.hierarchical_all_reduce(q16, dp_axes, torch.add)
        return _opt_decode(r, scale), None
    raise ValueError(cfg.mode)


# ---------------------------------------------------------------------------
# reduce-scatter / all-gather API (ZeRO-1 training path)
# ---------------------------------------------------------------------------

def reduce_scatter(g: torch.Tensor, dp_axes: tuple[Axis, ...],
                   cfg: IncAggConfig) -> torch.Tensor:
    """Flat fp32 (L,) -> this rank's fully reduced fp32 chunk (L/n_dp,).

    The scattered output IS the ZeRO-1 optimizer shard: the ring's scatter
    replaces a separate sharding step, exactly the "the network computes and
    delivers only your part" economy of the paper's CntFwd-gated SyncAgtr.
    """
    chunks = [_reduce_scatter_one(s, dp_axes, cfg)
              for s in _split_streams(g, cfg.n_streams)]
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks)


def _reduce_scatter_one(g, dp_axes, cfg):
    if cfg.mode == "xla-psum":
        x = g
        for ax in dp_axes:
            x = _psum_scatter(x, ax)
        return x
    if cfg.mode == "fp32-ring":
        return ring.hierarchical_reduce_scatter(g, dp_axes, torch.add)
    if cfg.mode == "netrpc":
        q = quantize(g, cfg.precision)
        r = ring.hierarchical_reduce_scatter(q, dp_axes, ops.sat_add)
        x, mask = dequantize(r, cfg.precision)
        if cfg.fallback == "always":
            # the software path re-reduces (scattered) and we keep only the
            # overflowed lanes; no mask exchange is needed because the fp32
            # re-reduction is computed for every lane of the owned chunk.
            repaired = ring.hierarchical_reduce_scatter(g, dp_axes,
                                                        torch.add)
            x = torch.where(mask, repaired, x)
        return x
    if cfg.mode == "netrpc-opt":
        q16, scale = _opt_encode(g, dp_axes)
        r = ring.hierarchical_reduce_scatter(q16, dp_axes, torch.add)
        # slice the (replicated) scale vector down to this rank's chunk
        my = _owned_offset(dp_axes, r.shape[0])
        scale_chunk = scale[my // _BLOCK:my // _BLOCK + r.shape[0] // _BLOCK]
        return r.to(torch.float32) * scale_chunk.repeat_interleave(_BLOCK)
    raise ValueError(cfg.mode)


def all_gather(chunk: torch.Tensor, dp_axes: tuple[Axis, ...],
               cfg: IncAggConfig) -> torch.Tensor:
    """Rank-owned chunk -> full buffer (used for the updated params)."""
    if cfg.mode == "xla-psum":
        x = chunk
        for ax in reversed(dp_axes):
            x = _all_gather_tiled(x, ax)
        return x
    return ring.hierarchical_all_gather(chunk, dp_axes)


def _owned_offset(dp_axes: tuple[Axis, ...], chunk_len: int) -> int:
    """Flat offset of this rank's owned chunk after hierarchical RS.

    RS over axes (a0, a1, ...) nests chunk indices: a0 major, a1 minor, ...
    """
    off = 0
    span = chunk_len
    for ax in reversed(dp_axes):
        off = off + compat.axis_index(ax) * span
        span = span * compat.axis_size(ax)
    return off


# ---------------------------------------------------------------------------
# netrpc-opt encode/decode: shared-scale int8 payload, int16 on the wire
# ---------------------------------------------------------------------------

def _int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, or 1 where amax is 0. A tensor divisor: PyTorch's CUDA
    division by a scalar multiplies by its reciprocal, which is not the
    reference's (or the CPU's) divide."""
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def _opt_encode(g: torch.Tensor, dp_axes: tuple[Axis, ...]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (L,) -> (int16 (L,), fp32 block scales (L/128,)).

    The scale is the *global* per-block amax (max over DP), so every rank
    quantizes against the same grid and integer partial sums are exact.
    127 * n_dp must fit int16 -> statically overflow-free for n_dp <= 258.
    """
    L = g.shape[0]
    if L % _BLOCK:
        raise ValueError(f"length {L} is not a multiple of {_BLOCK}")
    blocks = g.reshape(L // _BLOCK, _BLOCK)
    scale = _int8_scale(_pmax(blocks.abs().amax(dim=1), dp_axes))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int16).reshape(L), scale


def _opt_decode(r: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    L = r.shape[0]
    return (r.to(torch.float32).reshape(L // _BLOCK, _BLOCK)
            * scale[:, None]).reshape(L)


def opt_mode_static_check(dp_sizes: tuple[int, ...]) -> None:
    n = int(reduce(lambda a, b: a * b, dp_sizes, 1))
    if 127 * n > _INT16_MAX:
        raise ValueError(
            f"netrpc-opt int16 wire format needs 127*n_dp <= {_INT16_MAX}; "
            f"n_dp={n}. Use hierarchical int32 promotion or netrpc mode.")


# ---------------------------------------------------------------------------
# per-leaf (dim-wise) API — the train-step path
# ---------------------------------------------------------------------------
# Each gradient leaf is reduce-scattered along its own dp-divisible dim
# (chosen by sharding/rules.fsdp_dim): the leaf IS the paper's FPArray
# stream, and leaves aggregate as independent concurrent flows (the
# paper's automatic data parallelism, M9).
#
# Kernels: the reference runs the kernels.ref oracles here. The port runs
# ``ops.quantize`` / ``ops.sat_add`` / ``ops.dequantize``, which are exact
# against those oracles: kernels 7, 6 and 8 on the card, their plain
# versions on the CPU.

def _lead(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-dim-0 vector shaped to broadcast over an ``ndim`` tensor."""
    return scale.reshape(-1, *([1] * (ndim - 1)))


def _row_amax(x: torch.Tensor) -> torch.Tensor:
    """max|x| over every dim but 0 (the reference's max over trailing
    axes; a 1-D x has none, so it is |x| itself), as max(max x, -min x):
    the same value, with no |x| the size of x."""
    if x.dim() == 1:
        return x.abs()
    dims = tuple(range(1, x.dim()))
    return torch.maximum(x.amax(dim=dims), x.amin(dim=dims).neg())


def reduce_scatter_dim(g: torch.Tensor, dim: int, dp_axes: tuple[Axis, ...],
                       cfg: IncAggConfig) -> torch.Tensor:
    """fp32/bf16 leaf -> this rank's fully reduced fp32 chunk along `dim`.

    Output keeps the original dim order with dim shrunk by n_dp; chunk
    ownership is dp_axes[0]-major (matches hierarchical_all_gather and
    the tiled psum_scatter/all_gather).
    """
    x = torch.movedim(g, dim, 0).to(torch.float32)
    if cfg.mode == "xla-psum":
        out = x
        for ax in dp_axes:
            out = _psum_scatter(out, ax)
    elif cfg.mode == "fp32-ring":
        out = ring.hierarchical_reduce_scatter(x, dp_axes, torch.add)
    elif cfg.mode == "netrpc":
        r = ring.hierarchical_reduce_scatter(quantize(x, cfg.precision),
                                             dp_axes, ops.sat_add)
        val, mask = dequantize(r, cfg.precision)
        del r
        if cfg.fallback == "always":
            # the overflowed lanes from an fp32 reduce-scatter of the
            # leaf along the same dim, as the flat API repairs. The
            # reference psums each rank's own chunk of its own leaf
            # (its lines 271-277), which adds chunk r of rank r to chunk
            # s of rank s: right on one rank only (ROADMAP: departures)
            repaired = ring.hierarchical_reduce_scatter(x, dp_axes,
                                                        torch.add)
            val = torch.where(mask, repaired, val)
        out = val
    elif cfg.mode == "netrpc-opt":
        # per-row shared scale, int16 wire, statically overflow-free
        scale = _int8_scale(_pmax(_row_amax(x), dp_axes))
        q = torch.clamp(torch.round(x / _lead(scale, x.dim())),
                        -127, 127).to(torch.int16)
        r = ring.hierarchical_reduce_scatter(q, dp_axes, torch.add)
        c = x.shape[0] // dp_size(dp_axes)
        off = ring.dp_index(dp_axes) * c
        out = r.to(torch.float32) * _lead(scale[off:off + c], x.dim())
    else:
        raise ValueError(cfg.mode)
    return torch.movedim(out, 0, dim)


def all_gather_dim(x: torch.Tensor, dim: int, dp_axes: tuple[Axis, ...],
                   cfg: IncAggConfig) -> torch.Tensor:
    """Inverse of reduce_scatter_dim (used to rebuild updated params)."""
    y = torch.movedim(x, dim, 0)
    if cfg.mode == "xla-psum":
        for ax in reversed(dp_axes):
            y = _all_gather_tiled(y, ax)
    else:
        y = ring.hierarchical_all_gather(y, dp_axes)
    return torch.movedim(y, 0, dim)


# elements a q8 pass takes at a time on the CPU (whole slices of the leaf's
# dim 0, in its own layout), in one fp32 block reused for every pass:
# passes over a few MiB that stay in cache run several times faster there
# than passes over the whole leaf, and a block allocated afresh each time
# is faulted in again each time; the card takes the leaf in one piece
_Q8_CPU_ELEMS = 1 << 21


def all_gather_dim_q8(x: torch.Tensor, dim: int, dp_axes: tuple[Axis, ...],
                      model: Axis | None = None) -> torch.Tensor:
    """Quantized parameter gather (ZeRO++-style, beyond-paper): the local
    shard is block-quantized to int8 with one fp32 scale per row along
    ``dim`` (the max over every other dim) — the same shared-scale scheme
    as the netrpc-opt wire format — gathered at 1 B/element instead of 2
    (bf16), and dequantized locally. It quantizes at one rank too, where
    each block is dequantized as soon as it is quantized, from its fp32
    values, which are the int8 values exactly (a gather over one rank is
    the identity). With ``model`` (the leaf also cut over that axis) a
    row's max is taken over the axis too: the reference's, whose gather
    sees the leaf whole over "model"."""
    axes = [ax for ax in reversed(dp_axes) if compat.axis_size(ax) > 1]
    amax = _row_amax(torch.movedim(x, dim, 0)).float()
    if model is not None:
        amax = _pmax(amax, (model,))
    scale = _int8_scale(amax)
    at = [1] * x.dim()
    at[dim] = -1                      # the scales broadcast along dim
    n = x.shape[0]
    step = n if x.is_cuda else max(1, _Q8_CPU_ELEMS // max(1, x[0].numel()))
    block = torch.empty((min(step, n),) + tuple(x.shape[1:]),
                        dtype=torch.float32, device=x.device)
    q8 = torch.empty(x.shape, dtype=torch.int8, device=x.device) \
        if axes else None
    out = None if axes else torch.empty_like(
        x, memory_format=torch.contiguous_format)
    for a in range(0, n, step):
        c = block[:min(step, n - a)]
        c.copy_(x[a:a + step])
        s = scale.reshape(at)
        s = s[a:a + step] if dim == 0 else s
        c.div_(s).round_().clamp_(-127, 127)       # int8 values, exactly
        if axes:
            q8[a:a + step].copy_(c)
        else:               # one rank: dequantized from the block itself
            out[a:a + step].copy_(c.mul_(s))
    if out is not None:
        return out
    qg, sg = torch.movedim(q8, dim, 0), scale
    for ax in axes:
        qg = _all_gather_tiled(qg, ax)
        sg = _all_gather_tiled(sg, ax)
    return torch.movedim(qg.float() * _lead(sg, qg.dim()), 0,
                         dim).to(x.dtype)

"""Tensor parallelism over the mesh's "model" axis: the collectives that
the reference never writes.

The reference runs its steps as ``shard_map`` manual over the data axes
and AUTO over "model": it shards each leaf by ``rules.tp_dim`` and lets
GSPMD insert the collectives the cut dims need. It has no counterpart of
this module. Eager PyTorch has no GSPMD, so the port places each
collective itself, as ``torch.autograd.Function``s over the model axis'
group (``compat.Mesh.axes["model"].group``):

  to_model      identity forward, all-reduce backward: a replicated
                tensor entering work that is cut over "model" (each rank's
                gradient of it is a partial sum);
  from_model    all-reduce forward, identity backward: the partial sums
                of a product whose contracting dim is cut over "model";
  gather_model  all-gather along ``dim`` forward, this rank's slice
                backward (the vocab-parallel logits, the projected
                memory, the encoder's final norm scale, the conv tails
                of the recurrent caches);
  sum_model     all-reduce forward and backward: a statistic summed
                over the ranks' cuts that cut work on every rank then
                uses (the SSD's gated RMS norm over a cut ``d_inner``).

The rule that places them: an all-reduce follows a product whose
contracting dim is cut over "model", straight after that product, and
follows no other product. Over a model axis of one rank (or ``None``)
each is the identity, as XLA drops a collective over one device.

The sums keep the one-rank rounding: a bf16 product accumulates in fp32
and rounds once, so a product of the cut work runs on fp32 operands and
its partial sums add in fp32 before that one rounding. ``column`` is a
product whose output dim is cut (its input through ``to_model``, so the
partial input-gradients of the ranks add in fp32 and round once, in the
backward of the input's cast, as the one-rank product's input-gradient
does), ``row`` one whose contracting dim is cut, summed over the axis in
fp32 and rounded once. Rounded to bf16 before the sums, each rank's
partial products moved the clip's global norm of the reduced gemma3-27b
(8 layers) at model 2 by 1.8e-3 from the one-rank step's.
``kv_heads`` says which KV heads a rank's query heads read, for the
attention, its decode cache and ``launch/steps.py``'s cache specs.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import compat


def active(axis):
    """``axis`` when it holds more than one rank, else None."""
    if axis is None or compat.axis_size(axis) == 1:
        return None
    return axis


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, taken in fp32 for a bf16 ``x`` (and rounded
    back once)."""
    out = x.float() if x.dtype == torch.bfloat16 else x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _sum(ct, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _sum(ct, ctx.group), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.args = (dim, x.shape[dim], r)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, ct):
        dim, c, r = ctx.args
        return ct.narrow(dim, r * c, c), None, None


def to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """Identity; its backward all-reduces the gradient over ``axis``."""
    if active(axis) is None:
        return x
    return _ToModel.apply(x, axis.group)


def from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; its backward is the identity."""
    if active(axis) is None:
        return x
    return _FromModel.apply(x, axis.group)


def cut(n: int, whole: int, axis):
    """``axis`` when a leaf's dim of ``n`` is this rank's cut of a dim of
    ``whole`` (shorter), else None: whether a sub-layer runs cut is read
    from its leaves' shapes."""
    return None if axis is None or n == whole else axis


def sum_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; its backward sums the cotangents
    over the axis too (``to_model(from_model(x))``)."""
    if active(axis) is None:
        return x
    return _SumModel.apply(x, axis.group)


def gather_model(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``, rank order; its backward takes
    this rank's slice."""
    if active(axis) is None:
        return x
    return _GatherModel.apply(x, dim % x.dim(), axis.group)


class Product(NamedTuple):
    """A product ``op(x, w)`` of the model, as the one-rank code calls
    it, and its einsum equation (every index of an operand in the other
    or in the output), from which ``column`` takes its backward."""
    op: Callable
    eq: str


def einsum(eq: str) -> Product:
    return Product(partial(torch.einsum, eq), eq)


MATMUL = Product(torch.matmul, "...d,df->...f")
BMM = Product(torch.bmm, "ecd,edf->ecf")


class _Column(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, prod, group):
        ctx.save_for_backward(x, w)
        ctx.eq, ctx.group = prod.eq, group
        return prod.op(x, w)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        (a, b), c = (t.split(",") if "," in t else t
                     for t in ctx.eq.split("->"))
        ct = ct.float()
        dx = torch.einsum(f"{c},{b}->{a}", ct, w.float())
        dw = torch.einsum(f"{a},{c}->{b}", x.float(), ct)
        return _sum(dx, ctx.group).to(x.dtype), dw.to(w.dtype), None, None


def column(prod: Product, x: torch.Tensor, w: torch.Tensor,
           axis) -> torch.Tensor:
    """``prod.op(x, w)``, ``w``'s output dim cut over ``axis`` and ``x``
    whole: the forward as it is; the backward's products in fp32, the
    input-gradient's partial sums added over the axis in fp32 and rounded
    once (``prod.op(x, w)`` itself when ``axis`` is not active)."""
    if active(axis) is None:
        return prod.op(x, w)
    return _Column.apply(x, w, prod, axis.group)


def row(prod: Product, x: torch.Tensor, w: torch.Tensor,
        axis) -> torch.Tensor:
    """``prod.op(x, w)``, whose contracting dim is cut over ``axis``: the
    fp32 partial products summed over the axis and rounded once to
    ``x``'s dtype (``prod.op(x, w)`` itself when ``axis`` is not
    active)."""
    if active(axis) is None:
        return prod.op(x, w)
    return from_model(prod.op(x.float(), w.float()), axis).to(x.dtype)


def kv_heads(n_heads: int, n_kv: int, n_model: int, rank: int
             ) -> tuple[int, int]:
    """(first, count) of the KV heads that rank ``rank`` of a model axis
    of ``n_model`` holds and attends with:

      - the query heads do not split (``rules.tp_dim`` leaves wq whole):
        the attention is whole on every rank, all KV heads;
      - the KV heads split: the rank's block of them, as ``rules.tp_dim``
        cuts wk and wv;
      - only the query heads split (qwen2.5-3b at 4: 16 query heads, 2 KV
        heads): query head h reads KV head h // (n_heads / n_kv), so the
        rank holds, whole, the one KV head its block of query heads reads.
        The reference's cache cuts ``head_dim`` here instead (ROADMAP,
        queue 3). A block of query heads that reads more than one KV head
        raises."""
    if n_heads % n_model or n_heads < n_model:
        return 0, n_kv
    if n_kv % n_model == 0 and n_kv >= n_model:
        c = n_kv // n_model
        return rank * c, c
    per, group = n_heads // n_model, n_heads // n_kv
    if group % per:
        raise NotImplementedError(
            f"tensor parallelism over {n_model} ranks: a rank's {per} query "
            f"heads read more than one of {n_kv} KV heads")
    return rank * per // group, 1

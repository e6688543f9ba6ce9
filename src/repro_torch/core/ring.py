"""Ring collectives with per-hop INC semantics.

The NetRPC data plane as a ring reduce-scatter over ``torch.distributed``:
each hop performs the switch's `Map.addTo` (saturating int32 add with
sticky overflow sentinels, ``ops.sat_add``) on the in-flight chunk. Every
hop plays the role of one switch traversal; the chunk is the "packet";
the rank-resident chunk is the "switch register segment".

Axes are the mesh axes of ``compat.make_mesh`` (one process group each).
Functions operate on *pre-chunked* buffers: dim 0 is the chunk index
(length = axis size). One hop is one ``dist.batch_isend_irecv``: send to
the next rank of the axis, ``(j+1) % n``, receive from ``(j-1) % n``. The
JAX package's ``fori_loop`` over ``ppermute`` is a Python loop here, with
the same hop order and ownership convention, so the fp32 ring is bitwise
equal to the reference and saturation happens at the same adds.

Ownership convention: after reduce_scatter over an axis of size n, rank j
holds fully-reduced chunk j. all_gather inverts it.

Algorithm (classic ring): n-1 hops for RS, n-1 for AG. Wire bytes per rank:
2 * (n-1)/n * L * itemsize.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.compat import Axis
from repro_torch.kernels import ops

AddFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _ppermute(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """One ring hop: x goes to the next rank of the axis, and the previous
    rank's x comes back. Sent as bytes, so any dtype rides either backend."""
    n = compat.axis_size(axis)
    j = compat.axis_index(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.reshape(-1).view(torch.uint8),
                   axis.ranks[(j + 1) % n], axis.group),
        dist.P2POp(dist.irecv, out.reshape(-1).view(torch.uint8),
                   axis.ranks[(j - 1) % n], axis.group)])
    for r in reqs:
        r.wait()
    return out


# -- pre-chunked primitives ---------------------------------------------------

def reduce_scatter_chunked(buf: torch.Tensor, axis: Axis,
                           add: AddFn) -> torch.Tensor:
    """buf: (n, ...) chunk-indexed on dim 0 -> this rank's reduced chunk (...).

    Rank j ends holding fully-reduced chunk j.
    """
    n = compat.axis_size(axis)
    j = compat.axis_index(axis)
    if buf.shape[0] != n:
        raise ValueError(f"buffer has {buf.shape[0]} chunks for an axis of "
                         f"size {n}")
    acc = torch.zeros_like(buf[0])
    for s in range(n - 1):
        # chunk this rank forwards at step s: index (j - s - 1) mod n.
        # add(0, chunk) == chunk for both fp add and saturating add (sticky
        # sentinels propagate through), so step 0 needs no special case.
        acc = _ppermute(add(acc, buf[(j - s - 1) % n]), axis)
    return add(acc, buf[j])


def all_gather_chunked(chunk: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Inverse scatter: circulate reduced chunks. chunk j at rank j ->
    (n, ...)."""
    n = compat.axis_size(axis)
    j = compat.axis_index(axis)
    buf = torch.zeros((n,) + tuple(chunk.shape), dtype=chunk.dtype,
                      device=chunk.device)
    buf[j] = chunk
    cur = chunk
    for s in range(n - 1):
        cur = _ppermute(cur, axis)
        # after s+1 hops we hold the chunk owned by rank (j - s - 1) mod n
        buf[(j - s - 1) % n] = cur
    return buf


# -- flat-buffer wrappers -----------------------------------------------------

def ring_reduce_scatter(x: torch.Tensor, axis: Axis,
                        add: AddFn) -> torch.Tensor:
    """Flat (L,) per-rank buffer -> this rank's reduced chunk (L/n,)."""
    n = compat.axis_size(axis)
    L = x.shape[0]
    if L % n:
        raise ValueError(f"length {L} does not divide by axis size {n}")
    return reduce_scatter_chunked(x.reshape(n, L // n), axis, add)


def ring_all_gather(chunk: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rank-j-owns-chunk-j (c,) -> full (n*c,) reduced buffer on every rank."""
    n = compat.axis_size(axis)
    return all_gather_chunked(chunk, axis).reshape(n * chunk.shape[0])


def ring_all_reduce(x: torch.Tensor, axis: Axis, add: AddFn) -> torch.Tensor:
    return ring_all_gather(ring_reduce_scatter(x, axis, add), axis)


def hierarchical_reduce_scatter(x: torch.Tensor, axes: tuple[Axis, ...],
                                add: AddFn) -> torch.Tensor:
    """RS over axes[0], then axes[1], ... on the shrinking owned chunk.

    The paper's two-switch chaining (§6.6) generalized: the first axis is
    the inner ring; later axes (e.g. "pod") reduce the already-scattered
    chunks so outer traffic is 1/n_inner of the buffer.

    x: (F, ...) — dim 0 divisible by prod(axis sizes). Ownership is
    axes[0]-major.
    """
    for ax in axes:
        n = compat.axis_size(ax)
        f = x.shape[0]
        if f % n:
            raise ValueError(f"dim 0 ({f}) does not divide by axis "
                             f"{ax.name!r} of size {n}")
        x = reduce_scatter_chunked(x.reshape(n, f // n, *x.shape[1:]), ax,
                                   add)
    return x


def hierarchical_all_gather(chunk: torch.Tensor, axes: tuple[Axis, ...]
                            ) -> torch.Tensor:
    """Inverse of hierarchical_reduce_scatter: (c, ...) -> (n_dp*c, ...)."""
    for ax in reversed(axes):
        n = compat.axis_size(ax)
        buf = all_gather_chunked(chunk, ax)      # (n, c, ...)
        chunk = buf.reshape(n * chunk.shape[0], *chunk.shape[1:])
    return chunk


def hierarchical_all_reduce(x: torch.Tensor, axes: tuple[Axis, ...],
                            add: AddFn) -> torch.Tensor:
    return hierarchical_all_gather(hierarchical_reduce_scatter(x, axes, add),
                                   axes)


def dp_index(axes: tuple[Axis, ...]) -> int:
    """Row-major rank over the product of the given axes."""
    idx = 0
    for ax in axes:
        idx = idx * compat.axis_size(ax) + compat.axis_index(ax)
    return idx


# -- INC-flavored instantiations ---------------------------------------------

def sat_ring_all_reduce(q: torch.Tensor, axes: tuple[Axis, ...]
                        ) -> torch.Tensor:
    """int32 all-reduce where every hop is the switch's saturating
    Map.addTo."""
    return hierarchical_all_reduce(q, axes, ops.sat_add)


def fp32_ring_all_reduce(x: torch.Tensor, axes: tuple[Axis, ...]
                         ) -> torch.Tensor:
    """Software-datapath all-reduce (the BytePS-style baseline)."""
    return hierarchical_all_reduce(x, axes, torch.add)

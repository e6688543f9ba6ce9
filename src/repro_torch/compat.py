"""Named mesh axes over ``torch.distributed``: the port's counterpart of
``repro/compat.py`` (``make_mesh``, ``axis_size``).

The JAX package runs its collectives inside ``shard_map`` over named mesh
axes. Here every process is one rank, and a mesh axis is a process group:
``make_mesh(shape, names)`` lays the initialized default group's ranks
out row-major over ``shape`` and builds, for each axis, the group of
ranks that differ only in that axis' coordinate. ``axis_size(axis)`` and
``axis_index(axis)`` are that group's size and this rank's place in it.
Ranks along an axis are increasing in the coordinate, so the group rank
is the coordinate.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: its process group and the
    global ranks of the group, in coordinate order."""
    name: str
    group: object               # torch.distributed ProcessGroup
    ranks: tuple[int, ...]


@dataclass(frozen=True)
class Mesh:
    shape: tuple[int, ...]
    names: tuple[str, ...]
    axes: dict                  # name -> this rank's Axis

    def axes_of(self, names: Sequence[str]) -> tuple[Axis, ...]:
        return tuple(self.axes[n] for n in names)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None) -> Mesh:
    """A mesh over the initialized default process group.

    ``device=None`` means the card and NCCL groups; without a card it
    raises. ``device="cpu"`` means gloo groups, ``device="meta"`` (the
    dry run) groups of the default group's backend (the fake one of
    ``launch/dryrun.py``, which builds no gloo group). Every rank must
    call this with the same arguments, in the same order as its other
    group creations (each group is created collectively)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh runs on a CUDA device (NCCL) by default and none is "
            "available; pass device='cpu' for gloo groups on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(init_process_group) first")
    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"default group has {world}")
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    me = dist.get_rank()
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    axes = {}
    for a, name in enumerate(names):
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            coord = list(rest)
            coord.insert(a, 0)
            base = sum(c * st for c, st in zip(coord, strides))
            ranks = tuple(base + k * strides[a] for k in range(shape[a]))
            group = dist.new_group(list(ranks), backend=backend)
            if me in ranks:
                axes[name] = Axis(name, group, ranks)
    return Mesh(shape, names, axes)


def axis_size(axis: Axis) -> int:
    """Size of a mesh axis (``jax.lax.axis_size``)."""
    return dist.get_world_size(axis.group)


def axis_index(axis: Axis) -> int:
    """This rank's coordinate along a mesh axis (``jax.lax.axis_index``)."""
    return dist.get_rank(axis.group)

"""Production and host meshes: the port of ``repro/launch/mesh.py``.

Functions, not module-level constants: a mesh is built over the
``torch.distributed`` world that the caller initialized (every rank
calls with the same arguments), NCCL groups on the card and gloo groups
with ``device="cpu"`` (``compat.make_mesh``).
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch import compat


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed initialized "
                           "(init_process_group) first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``, over a world of that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return compat.make_mesh(shape, axes, device=device)


def make_host_mesh(model: int = 2, *, device=None):
    """(world // model, model) over ("data", "model"): the mesh of the
    multi-rank tests and of ``launch/train.py`` under
    ``torch.distributed.run``."""
    n = _world()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {n} ranks")
    return compat.make_mesh((n // model, model), ("data", "model"),
                            device=device)

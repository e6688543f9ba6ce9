"""Production and host meshes: the port of ``repro/launch/mesh.py``,
and the world the launchers build them over.

Functions, not module-level constants: a mesh is built over the
``torch.distributed`` world that the caller initialized (every rank
calls with the same arguments), NCCL groups on the card and gloo groups
with ``device="cpu"`` (``compat.make_mesh``). ``world_group`` makes that
world for ``launch/train.py`` and ``launch/serve.py``: the ranks of
``torch.distributed.run``, or one rank.
"""
from __future__ import annotations

import contextlib
import math
import os
import socket
from datetime import timedelta

import torch
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


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """A default process group of one rank for the loop, unless the
    caller already made one: NCCL on the card, gloo on the CPU."""
    if dist.is_initialized():
        yield
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def world_group(device: torch.device):
    """The default process group of the loop: the world of
    ``torch.distributed.run`` (``RANK`` and ``WORLD_SIZE`` in the
    environment, ``env://``), else ``one_rank_group``; a group the
    caller already made is kept."""
    if dist.is_initialized() or not {"RANK", "WORLD_SIZE"} <= set(
            os.environ):
        with one_rank_group(device):
            yield
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://",
                            timeout=timedelta(seconds=300))
    try:
        yield
    finally:
        dist.destroy_process_group()

"""Checkpoint save/restore with exactly-once (step-parity) semantics: the
port of ``repro/checkpoint/store.py``, with its on-disk layout.

The paper's flip-bit idempotent retransmission (§5.1) re-appears at cluster
scale as checkpoint/restart: a re-executed step must not double-apply. Each
checkpoint carries (step, flip = step % 2); a restarted trainer compares the
incoming step's flip against the persisted one — equal flip means the step's
effects are already in the checkpoint (the "retransmission"), so the trainer
skips re-applying and only replays data to advance its cursor.

Layout (the reference's, key for key, so either package restores what the
other wrote):
  <dir>/step_<n>/manifest.json        {"step": n, "flip": n%2, ...}
  <dir>/step_<n>/<tree>.npz           one npz per saved tree; keys are
                                      tree paths, "groups/0/s0/attn/wq"
bf16 leaves are stored as fp32 (exact). Writes go to a tmp dir + atomic
rename, so a crash mid-save never yields a readable-but-corrupt
checkpoint. Saves run on a background thread (async checkpointing): the
tensors are copied to host memory before ``save`` returns, and ``wait()``
joins before the next save.

A tree is a nested dict (or tuple/list) of tensors or numpy arrays, or a
``models.api.Tree``; ``restore`` rebuilds the structure of the tree it is
given, with its leaves' dtypes and devices.

Several ranks: the reference's single controller saves each global
array whole (``np.asarray`` of a sharded array gathers it), so a
checkpoint holds full leaves whatever the mesh. Given ``specs`` (per
tree, {leaf path: ``rules.PartitionSpec``}, e.g.
``launch.steps.state_specs``) and the ``mesh``, ``save`` gathers each
sharded leaf from every rank (every rank calls it) and rank 0 alone
writes; ``restore`` reads the full leaf on every rank and keeps this
rank's shard. So a state written by any number of ranks restores in the
reference, onto another dp size, or the other way round.

Elastic resize: ZeRO state is saved per-leaf along its scatter dim, so
restoring onto a different dp size = concatenate chunks and re-slice
(resize_chunks), no re-initialization.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding import rules


def _items(tree):
    """(key, child) pairs of one tree level, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree._parameters.items()) + list(tree._modules.items())
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, prefix=()):
    items = _items(tree)
    if items is None:
        yield "/".join(prefix), tree
        return
    for key, child in items:
        yield from _leaves(child, prefix + (str(key),))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:        # npz has no bfloat16
            t = t.float()                    # (exact: f32 superset of bf16)
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _spec(specs, key: str):
    """The spec of the leaf at ``key`` ("groups/0/s0/attn/wq") in a
    {leaf path: spec} dict, or in one nested under the key's first
    component (the optimizer's {"master": {...}, ...}); None if none."""
    if not specs:
        return None
    if key.replace("/", ".") in specs:
        return specs[key.replace("/", ".")]
    head, _, rest = key.partition("/")
    sub = specs.get(head)
    return _spec(sub, rest) if isinstance(sub, dict) and rest else None


def _flatten(tree, specs=None, mesh=None) -> dict[str, np.ndarray]:
    out = {}
    for key, leaf in _leaves(tree):
        spec = _spec(specs, key)
        if spec is not None:
            leaf = rules.unshard(leaf.detach(), spec, mesh)
        out[key] = _to_numpy(leaf)
    return out


def _leaf(like, arr: np.ndarray):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            dtype=like.dtype, device=like.device).reshape(like.shape)
    like = np.asarray(like)
    try:
        arr = np.asarray(arr, dtype=like.dtype)
    except ValueError:                       # e.g. -> bfloat16 via float32
        arr = np.asarray(arr, np.float32).astype(like.dtype)
    return arr.reshape(like.shape)


def _read(flat: dict[str, np.ndarray], prefix: tuple, specs, mesh):
    """The stored leaf at ``prefix``, cut to this rank's shard when
    ``specs`` has a spec for it."""
    key = "/".join(prefix)
    spec = _spec(specs, key)
    if spec is None:
        return flat[key]
    return rules.shard_of(torch.from_numpy(np.array(flat[key])), spec,
                          mesh).numpy()


def _plain(like, flat: dict[str, np.ndarray], prefix=(), specs=None,
           mesh=None):
    """``like``'s structure as nested dicts and tuples (a module list is
    a tuple), with the leaves read from ``flat``."""
    items = _items(like)
    if items is None:
        return _leaf(like, _read(flat, prefix, specs, mesh))
    kids = [(k, _plain(v, flat, prefix + (str(k),), specs, mesh))
            for k, v in items]
    if isinstance(like, (nn.ModuleList, tuple, list)):
        return tuple(v for _, v in kids)
    return dict(kids)


def _rebuild(like, flat: dict[str, np.ndarray], prefix=(), specs=None,
             mesh=None):
    if isinstance(like, nn.Module):
        from repro_torch.models.api import Tree
        return Tree(_plain(like, flat, prefix, specs, mesh))
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, prefix + (str(k),), specs, mesh)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, flat, prefix + (str(i),), specs, mesh)
                          for i, v in enumerate(like))
    return _leaf(like, _read(flat, prefix, specs, mesh))


def _unflatten(tree_like, flat: dict[str, np.ndarray], specs=None,
               mesh=None):
    return _rebuild(tree_like, flat, (), specs, mesh)


class CheckpointStore:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -------------------------------------------------------------

    def save(self, step: int, trees: dict, extra: dict | None = None,
             async_: bool = True, specs: dict | None = None,
             mesh=None) -> None:
        """Save ``trees`` ({name: tree}) as step ``step``. With ``specs``
        ({name: {leaf path: spec}}) and ``mesh``, every rank calls this:
        the sharded leaves are gathered whole, and rank 0 writes."""
        specs = specs or {}
        trees_np = {name: _flatten(t, specs.get(name), mesh)
                    for name, t in trees.items()}
        if specs and dist.is_initialized() and dist.get_rank() != 0:
            return
        manifest = {"step": int(step), "flip": int(step) % 2,
                    **(extra or {})}
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, trees_np, manifest))
            self._thread.start()
        else:
            self._write(step, trees_np, manifest)

    def _write(self, step: int, trees_np: dict, manifest: dict) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for name, flat in trees_np.items():
            np.savez(tmp / f"{name}.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                     # atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step_{step:08d}" / "manifest.json").read_text())

    def restore(self, step: int, trees_like: dict,
                specs: dict | None = None, mesh=None) -> dict:
        """The trees of step ``step`` in the structure, dtypes and devices
        of ``trees_like``; with ``specs`` and ``mesh``, this rank's shard
        of each sharded leaf (``trees_like`` holds shards)."""
        specs = specs or {}
        d = self.dir / f"step_{step:08d}"
        out = {}
        for name, like in trees_like.items():
            with np.load(d / f"{name}.npz") as z:
                out[name] = _unflatten(like, dict(z), specs.get(name), mesh)
        return out

    # -- exactly-once gate (the flip bit) ----------------------------------

    def already_applied(self, step: int) -> bool:
        """True iff `step`'s effects are already persisted — the incoming
        step is a 'retransmission' and must be skipped (idempotence).
        The flip bit cross-checks manifest integrity like the switch's
        bit-equality test: a manifest whose flip mismatches its own step
        is corrupt and treated as not applied."""
        latest = self.latest_step()
        if latest is None or step > latest:
            return False
        return self.manifest(latest)["flip"] == latest % 2


def resize_chunks(chunks: list[np.ndarray], new_n: int, dim: int = 0
                  ) -> list[np.ndarray]:
    """Re-chunk ZeRO shards for a different dp size (elastic restore)."""
    full = np.concatenate(chunks, axis=dim)
    if full.shape[dim] % new_n:
        raise ValueError(f"dim {dim} of {full.shape} does not split into "
                         f"{new_n} chunks")
    return list(np.split(full, new_n, axis=dim))

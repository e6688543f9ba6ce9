"""Logical-to-mesh sharding rules for every parameter leaf: the port of
``repro/sharding/rules.py`` (kept copies, not imports).

Two parallelism modes:

  zero1  params replicated over the data axes (optimizer state ZeRO-1
         sharded along each leaf's scatter dim by the INC reduce-scatter),
         TP over 'model'.
  fsdp   params additionally sharded over the data axes on a "fsdp dim"
         (first dim divisible by n_dp, excluding the layer-stack dim and
         the TP dim); gathered per layer inside the layer loop, with the
         INC reduce-scatter as the backward path (grok-314b, llama-90b).

A leaf's path is the tuple of its tree keys, e.g. ``("groups", "0", "s0",
"attn", "wq")`` (a ``state_dict`` key split on "."); a tree of specs is a
dict from the "."-joined path to a ``PartitionSpec``. TP assignment is
name+shape based: heads dims for attention, d_ff for MLPs and experts,
vocab for embeddings. A dim is only sharded if its size divides the axis
size.

JAX places a sharded array by its ``NamedSharding``; here every process
is one rank of a ``compat.make_mesh`` mesh and holds its shard as a
plain tensor: ``shard_of`` cuts it from the full leaf, ``unshard``
gathers the full leaf back (for a checkpoint). An entry of several axes
is laid out with the first axis major, as JAX lays out
``PartitionSpec(("pod", "data"))``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

FSDP_ARCHS = ("grok-1-314b", "llama-3.2-vision-90b")


class PartitionSpec(tuple):
    """A leaf's placement, one entry a dim: None (replicated), a mesh axis
    name, or a tuple of names (sharded over their product). Trailing
    dims left out are replicated, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshAxes:
    data: tuple[str, ...]        # ("pod","data") or ("data",)
    model: str = "model"

    def sizes(self, mesh) -> tuple[int, int]:
        """(n_dp, n_model) of a ``compat.Mesh`` (only its ``names`` and
        ``shape`` are read)."""
        sizes = dict(zip(mesh.names, mesh.shape))
        n_dp = 1
        for ax in self.data:
            n_dp *= sizes[ax]
        return n_dp, sizes.get(self.model, 1)


def _path_names(path) -> list[str]:
    if isinstance(path, str):
        return path.split(".")
    return [str(k) for k in path]


def _leaf_name(path) -> str:
    return _path_names(path)[-1]


def _is_stacked(path) -> bool:
    names = _path_names(path)
    return ("groups" in names) or ("blocks" in names)


# TP dim by leaf name, counted from the END of the shape (stacked leaves
# have an extra leading layer dim, so negative indexing is uniform).
_TP_DIM_FROM_END = {
    # attention
    "wq": 2, "wk": 2, "wv": 2,            # (..., d, H, hd) -> H
    "wo": 3,                              # (..., H, hd, d) -> H
    "bq": 2, "bk": 2, "bv": 2,            # (..., H, hd)    -> H
    # dense mlp
    "w1": 1, "w3": 1,                     # (..., d, ff)    -> ff
    "w2": 2,                              # (..., ff, d)    -> ff
    "b1": 1,
    # ssm
    "w_z": 1, "w_x": 1, "w_dt": 1,        # (..., d, d_inner|H)
    "conv_x": 1, "conv_bx": 1,
    "dt_bias": 1, "A_log": 1, "D": 1,     # (..., H)
    "norm": 1,                            # (..., d_inner)
    "w_out": 2,                           # (..., d_inner|rnn, d)
    # rglru
    "w_in_a": 1, "w_in_b": 1,
    "conv_w": 1, "conv_b": 1,
    "wr": 3, "wi": 3,                     # (..., nb, c, c) -> nb
    "br": 1, "bi": 1, "lam": 1,
    # embeddings
    "embed": 2, "lm_head": 2,             # (V, d) -> V
    "mproj": 1,
}

# expert leaves: under an "experts" subtree the ff dim moves one inward
_TP_DIM_EXPERTS = {"w1": 1, "w3": 1, "w2": 2}


def tp_dim(path, shape, n_model: int) -> int | None:
    names = _path_names(path)
    name = names[-1]
    if "experts" in names:
        d = _TP_DIM_EXPERTS.get(name)
    else:
        d = _TP_DIM_FROM_END.get(name)
    if d is None or d > len(shape):
        return None
    dim = len(shape) - d
    if shape[dim] % n_model != 0 or shape[dim] < n_model:
        return None
    return dim


def fsdp_dim(path, shape, n_dp: int, taken: int | None) -> int | None:
    start = 1 if _is_stacked(path) else 0
    best = None
    for i in range(start, len(shape)):
        if i == taken:
            continue
        if shape[i] % n_dp == 0 and shape[i] >= n_dp:
            if best is None or shape[i] > shape[best]:
                best = i
    return best


def param_spec(path, leaf, axes: MeshAxes, n_dp: int, n_model: int,
               mode: str) -> PartitionSpec:
    shape = leaf.shape
    entries: list = [None] * len(shape)
    t = tp_dim(path, shape, n_model)
    if t is not None:
        entries[t] = axes.model
    if mode == "fsdp":
        f = fsdp_dim(path, shape, n_dp, t)
        if f is not None:
            entries[f] = axes.data if len(axes.data) > 1 else axes.data[0]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def param_specs(params_shape, axes: MeshAxes, mesh,
                mode: str) -> dict[str, PartitionSpec]:
    """{leaf path: PartitionSpec} of a params tree: a ``models.api.Tree``
    (meta tensors do) or its (path, tensor) pairs."""
    n_dp, n_model = axes.sizes(mesh)
    items = (params_shape.named_parameters()
             if hasattr(params_shape, "named_parameters") else params_shape)
    return {name: param_spec(name, leaf, axes, n_dp, n_model, mode)
            for name, leaf in items}


def manual_only(spec: PartitionSpec, manual: tuple[str, ...]
                ) -> PartitionSpec:
    """Strip the entries of axes not in ``manual`` from a spec (the
    reference's shard_map in_specs see only the manual axes)."""
    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in manual)
            return kept if kept else None
        return e if e in manual else None
    entries = [keep(e) for e in spec]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def manual_specs(specs: dict, manual: tuple[str, ...]) -> dict:
    return {k: manual_only(s, manual) for k, s in specs.items()}


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _place(mesh, names: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's index, count) over the product of mesh axes
    ``names``, the first axis major."""
    idx, n = 0, 1
    for name in names:
        ax = mesh.axes[name]
        size = dist.get_world_size(ax.group)
        idx = idx * size + dist.get_rank(ax.group)
        n *= size
    return idx, n


def shard_of(full: torch.Tensor, spec: PartitionSpec,
             mesh) -> torch.Tensor:
    """This rank's shard of the full leaf ``full`` under ``spec`` on
    ``mesh``. A leaf no dim of which is cut comes back as it is; a cut
    one is a contiguous copy, so the full leaf can be freed."""
    out = full
    for dim, entry in enumerate(spec):
        idx, n = _place(mesh, _entry_axes(entry))
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split over {n} ranks ({entry!r})")
        c = out.shape[dim] // n
        out = out.narrow(dim, idx * c, c)
    return out if out is full else out.clone(
        memory_format=torch.contiguous_format)


def unshard(shard: torch.Tensor, spec: PartitionSpec,
            mesh) -> torch.Tensor:
    """The full leaf from every rank's ``shard`` (the inverse of
    ``shard_of``): an all-gather along each cut dim, the minor axis
    first. Every rank of those axes must call it."""
    out = shard
    for dim, entry in enumerate(spec):
        for name in reversed(_entry_axes(entry)):
            group = mesh.axes[name].group
            n = dist.get_world_size(group)
            if n == 1:
                continue
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, dim=dim)
    return out


def mode_for(arch_name: str) -> str:
    return "fsdp" if arch_name in FSDP_ARCHS else "zero1"

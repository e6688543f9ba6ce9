"""Three-term roofline of one rank's call on an H100: the port of
``repro/roofline/analysis.py``.

  compute term    = dot_FLOPs / PEAK_FLOPS                        [s]
  memory term     = HBM_bytes / HBM_BW                            [s]
  collective term = sum of wire_bytes / the link of each group    [s]

The reference parses the optimized HLO of a compiled program. Eager
PyTorch compiles nothing, so the dry run (``launch/dryrun.py``) runs the
rank's step once on the meta device (shapes and dtypes, no data) under
``Counter``, a ``TorchDispatchMode`` that sees every aten and c10d op the
step issues:

  - compute = 2 * out_elems * contracted_size of every ``mm``, ``addmm``,
    ``bmm``, ``baddbmm`` and ``convolution`` (``matmul``, ``linear`` and
    ``einsum`` reach these), and of a convolution's backward;
  - memory = operands + outputs of every op that is not a view or a free
    op (allocation, alias, detach). Eager PyTorch does not fuse: each aten
    op is one kernel that reads its operands from HBM and writes its
    outputs, which is the reference's post-fusion model with one op a
    fusion;
  - collectives come from the c10d ops, the group size and ranks from the
    op's process group, with the reference's ring wire models (a ``send``
    of the ring's hop is its ``collective-permute``; the ``recv_`` that
    pairs with it adds nothing). Each collective also reads and writes
    its bytes in HBM, as in the reference;
  - the hand-written kernels launch nothing on meta tensors: each reports
    its analytic bytes and FLOPs (``kernels/backend.record_launch``), the
    count PERF.md's bounds take, in place of the plain version's
    intermediates (the reference's ``skip_scopes`` + ``extra_hbm_bytes``);
  - the peak is the most bytes of card storage alive at once during the
    call, its arguments included: the counterpart of ``memory_analysis``'s
    argument + temp sizes.

A Python loop runs every layer and microbatch, and each execution is
counted, so there is no trip-count logic: ``n_collectives`` counts calls
made, where the reference counts HLO instructions.

Hardware: one NVIDIA H100 SXM (datasheet figures, not measurements):
989 TFLOP/s dense bf16, 3.35 TB/s HBM3. A group inside one 8-GPU node
(ranks numbered node-major) runs over NVLink 4 at 450 GB/s a direction;
a group that spans nodes over InfiniBand, one 400 Gb/s NIC a GPU (DGX
H100), 50 GB/s.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import backend

PEAK_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
HBM_BW = 3.35e12             # H100 SXM HBM3, bytes/s
NVLINK_BW = 450e9            # NVLink 4, bytes/s a direction a GPU
IB_BW = 50e9                 # one 400 Gb/s InfiniBand NIC a GPU
NODE_GPUS = 8                # GPUs of one node (DGX H100)

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_PRODUCTS = _DOTS | {"convolution", "convolution_backward"}
# the c10d ops the port issues -> the reference's collective kind (a
# ``recv_`` pairs with a counted ``send``)
_COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "send": "collective-permute"}
# ops that move no data of their own besides the views: allocations, a
# view of a fresh result, a scalar read back to the host
_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
             "_unsafe_view", "_local_scalar_dense"}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


@dataclass
class CollectiveOp:
    kind: str
    computation: str
    out_bytes: int
    group_size: int
    multiplier: int = 1
    inter_node: bool = False     # the group spans nodes: InfiniBand

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        scale = (g - 1) / g if g > 1 else 0.0
        if self.kind == "collective-permute":
            w = self.out_bytes
        elif self.kind == "all-reduce":
            w = 2 * self.out_bytes * scale
        elif self.kind == "reduce-scatter":
            w = self.out_bytes * (g - 1)       # input = out * g
        else:          # all-gather (out = full) / all-to-all
            w = self.out_bytes * scale
        return w * self.multiplier


@dataclass
class Roofline:
    flops: float                  # per-rank dot FLOPs (every execution)
    hbm_bytes: float              # per-rank modeled HBM traffic
    wire_bytes: float             # per-rank modeled link traffic
    raw_collective_bytes: float   # unweighted operand-size sum
    n_collectives: int
    xla_flops: float = 0.0        # the reference's cost_analysis: no XLA
    xla_bytes: float = 0.0
    per_kind: dict = field(default_factory=dict)
    ib_wire_bytes: float = 0.0    # the part of wire_bytes over InfiniBand
    peak_bytes: int = 0           # most card bytes alive, arguments too
    arg_bytes: int = 0            # the call's arguments
    n_ops: int = 0                # aten and c10d ops the call issued
    kernels: dict = field(default_factory=dict)  # name -> launches, bytes,
    # flops of the meta-lane records; calls: kind -> "ranks" -> calls
    calls: dict = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return ((self.wire_bytes - self.ib_wire_bytes) / NVLINK_BW
                + self.ib_wire_bytes / IB_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "raw_collective_bytes": self.raw_collective_bytes,
            "n_collectives": self.n_collectives,
            "xla_flops": self.xla_flops, "xla_bytes": self.xla_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "per_kind": {k: round(v) for k, v in self.per_kind.items()},
            "ib_wire_bytes_per_dev": self.ib_wire_bytes,
            "peak_bytes": self.peak_bytes, "arg_bytes": self.arg_bytes,
            "n_ops": self.n_ops, "kernels": self.kernels,
            "calls": self.calls,
        }


def _dot_flops(name: str, args, out) -> float:
    """2 * out_elems * contracted size of a matrix product or a
    convolution (forward, or the products of its backward)."""
    if name in _DOTS:
        a = args[1] if name.startswith(("add", "badd")) else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    w = args[1] if name == "convolution" else args[2]
    per_out = 2.0 * math.prod(w.shape[1:])        # C_in / groups * kernel
    if name == "convolution":
        return per_out * out.numel()
    grad_out, mask = args[0], args[-1]
    return per_out * grad_out.numel() * (int(mask[0]) + int(mask[1]))


class Counter(TorchDispatchMode):
    """Counts FLOPs, HBM bytes, collectives, kernel records and the peak
    of live card bytes of everything run while it is open (see the
    module's docstring). ``args``: the call's arguments, alive from the
    start. ``roofline()`` gives the counts."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = self.hbm = self.wire = self.ib = self.raw = 0.0
        self.n_coll = self.n_ops = 0
        self.per_kind: dict[str, float] = {}
        self.calls: dict[str, dict[str, int]] = {}
        self.kernels: dict[str, dict] = {}
        self._live: dict[int, int] = {}
        self.live = self.peak = 0
        self._groups: dict[str, tuple[str, bool]] = {}
        self._args = args
        self.arg_bytes = 0

    def __enter__(self):
        for t in _tensors(self._args):
            self._track(t)
        self.arg_bytes = self.live
        backend.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        backend.RECORDERS.remove(self)
        return super().__exit__(*exc)

    # -- live storage ------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type not in ("meta", "cuda"):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    # -- the records -------------------------------------------------------

    def kernel(self, name: str, nbytes: float, flops: float) -> None:
        """One launch of a hand kernel on meta tensors
        (``backend.record_launch``)."""
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                           "flops": 0.0})
        k["launches"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        self.hbm += nbytes
        self.flops += flops

    def _group(self, pg) -> tuple[str, bool]:
        """(the group's ranks as "0,1,...", whether it spans nodes)."""
        name = pg.group_name
        if name not in self._groups:
            ranks = dist.get_process_group_ranks(pg)
            self._groups[name] = (",".join(map(str, ranks)),
                                  len({r // NODE_GPUS for r in ranks}) > 1)
        return self._groups[name]

    def _collective(self, name: str, args) -> None:
        if name in ("recv_", "barrier"):     # its send counted; no data
            return
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"the roofline has no wire model for "
                                      f"c10d.{name}")
        kind = _COLLECTIVES[name]
        pg = next(dist.ProcessGroup.unbox(a) for a in args
                  if isinstance(a, torch.ScriptObject)
                  and a._type().qualified_name().endswith(".ProcessGroup"))
        out_b = _nbytes(args[0])
        ranks, inter = self._group(pg)
        if name == "send":               # the link to the peer
            inter = dist.get_global_rank(pg, args[2]) // NODE_GPUS \
                != dist.get_rank() // NODE_GPUS
        op = CollectiveOp(kind, name, out_b, pg.size(), inter_node=inter)
        by = self.calls.setdefault(kind, {})
        by[ranks] = by.get(ranks, 0) + 1
        w = op.wire_bytes
        self.wire += w
        if op.inter_node:
            self.ib += w
        self.raw += out_b
        self.n_coll += 1
        self.per_kind[kind] = self.per_kind.get(kind, 0.0) + w
        self.hbm += 2 * out_b            # collectives touch HBM too

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._opname
        self.n_ops += 1
        if func.namespace == "c10d":
            self._collective(name, args)
        elif not (func.is_view or name in _FREE_OPS):
            if name in _PRODUCTS:
                self.flops += _dot_flops(name, args, out)
            self.hbm += _nbytes((args, kwargs)) + _nbytes(out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def roofline(self) -> Roofline:
        return Roofline(flops=self.flops, hbm_bytes=self.hbm,
                        wire_bytes=self.wire, raw_collective_bytes=self.raw,
                        n_collectives=self.n_coll,
                        per_kind=dict(self.per_kind),
                        ib_wire_bytes=self.ib, peak_bytes=self.peak,
                        arg_bytes=self.arg_bytes, n_ops=self.n_ops,
                        kernels={k: dict(v) for k, v in self.kernels.items()},
                        calls={k: dict(v) for k, v in self.calls.items()})


def _tensors(tree) -> list[torch.Tensor]:
    """Every tensor of a tree of dicts, tuples, lists and ``nn.Module``s."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a ``Counter`` whose
    arguments are ``args``; returns (its result, the ``Roofline``)."""
    with Counter(args) as c:
        out = fn(*args, **kwargs)
    return out, c.roofline()


def model_flops(n_params: int, n_active: int, kind: str, tokens: int) -> float:
    """MODEL_FLOPS: 6ND train / 2ND inference, N = active params."""
    return (6.0 if kind == "train" else 2.0) * n_active * tokens

"""Map.clear policies: copy / shadow / lazy (paper §5.2.2, Table 6).

The switch memory only supports addTo, not overwrite, so starting a new
accumulation round requires get + clear + addTo — and a packet loss between
get and clear would lose the value permanently. The paper offers three
policies trading latency / memory / throughput. The pipeline
(core/rpc.py) reads ``POLICIES`` to decide whether a Map.get writes its
clear back; the accumulator classes below are the policies as state
machines over int32 tensors on an explicit device (the card unless given
``device="cpu"``), accumulating through the saturating-add kernels
(``ops.sat_add``, and ``ops.sat_add_batch`` for a drained batch).

Structural costs (the Table-6 analogue, in round-trip "hops" and memory
multiplier):

  copy    1x memory, extra forward of the full value to the server each
          round (highest throughput on the switch, highest latency);
  shadow  2x memory, alternating segments (lowest latency, halves the
          usable register space);
  lazy    1x memory, no clears at all: the host subtracts the previous
          snapshot; overflow eventually forces a fallback reset.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.ref import is_sentinel

POLICIES = ("copy", "shadow", "lazy")


@dataclass
class ClearStats:
    memory_multiplier: int
    roundtrip_hops: int     # extra server round-trips per read cycle
    fallback_resets: int = 0


class _Policy:
    """Shared state handling: the device, update conversion and the numpy
    ``state_dict``/``load_state`` of the tensors each policy names in
    ``_STATE``."""

    _STATE: tuple[str, ...] = ()

    def __init__(self, n: int, device):
        self.device = resolve_device(device)
        self.n = n

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.n, dtype=torch.int32, device=self.device)

    def _q(self, q) -> torch.Tensor:
        """One update (numpy or tensor) as int32 on the policy's device."""
        if not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.asarray(q, np.int32))
        return q.to(self.device, torch.int32)

    def _stack(self, qs) -> torch.Tensor:
        """A drained batch as one (B, n) int32 tensor on the device."""
        return torch.stack([self._q(q) for q in qs])

    def state_dict(self) -> dict:
        out = {}
        for k in self._STATE:
            v = getattr(self, k)
            out[k] = ([t.cpu().numpy().copy() for t in v]
                      if isinstance(v, list) else v.cpu().numpy().copy())
        out["stats"] = dataclasses.asdict(self.stats)
        return out

    def load_state(self, state: dict) -> None:
        for k in self._STATE:
            v = state[k]
            setattr(self, k, [torch.from_numpy(np.array(a, np.int32))
                              .to(self.device) for a in v]
                    if isinstance(v, list) else
                    torch.from_numpy(np.array(v, np.int32)).to(self.device))
        self.stats = ClearStats(**state["stats"])


class CopyClear(_Policy):
    """Round value is copied to the server before the switch clears
    (§5.2.2.1).

    No extra switch memory; the value travels to the server (one extra
    "hop"), which keeps the backup in case the return packet is lost.
    """

    _STATE = ("acc", "server_backup")

    def __init__(self, n: int, device=None):
        super().__init__(n, device)
        self.acc = self._zeros()
        self.server_backup = self._zeros()
        self.stats = ClearStats(memory_multiplier=1, roundtrip_hops=2)

    def addto(self, q) -> None:
        self.acc = ops.sat_add(self.acc, self._q(q))

    def addto_batch(self, qs) -> None:
        """Fold a whole drained batch in ONE launch (== N addto calls)."""
        if len(qs):
            self.acc = ops.sat_add_batch(self.acc, self._stack(qs))

    def read_and_clear(self) -> torch.Tensor:
        self.server_backup = self.acc          # copy to server first
        out = self.server_backup
        self.acc = torch.zeros_like(self.acc)  # then clear the switch
        return out


class ShadowClear(_Policy):
    """Double-buffered segments: read one while the other accumulates."""

    _STATE = ("seg",)

    def __init__(self, n: int, device=None):
        super().__init__(n, device)
        self.seg = [self._zeros(), self._zeros()]
        self.active = 0
        self.stats = ClearStats(memory_multiplier=2, roundtrip_hops=1)

    def addto(self, q) -> None:
        self.seg[self.active] = ops.sat_add(self.seg[self.active], self._q(q))

    def addto_batch(self, qs) -> None:
        """One launch into the active segment per drained batch."""
        if len(qs):
            self.seg[self.active] = ops.sat_add_batch(self.seg[self.active],
                                                      self._stack(qs))

    def read_and_clear(self) -> torch.Tensor:
        out = self.seg[self.active]
        self.active ^= 1
        self.seg[self.active] = torch.zeros_like(out)  # clear the shadow
        return out

    def state_dict(self) -> dict:
        return {**super().state_dict(), "active": self.active}

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.active = int(state["active"])


class LazyClear(_Policy):
    """Never clear: host subtracts the last snapshot (§5.2.2.3).

    The switch keeps accumulating monotonically; overflow (sentinel) forces
    a fallback reset, whose frequency is the policy's throughput cost
    (Table 6 lazy 0%/1%/10% rows).
    """

    _STATE = ("acc", "snapshot")

    def __init__(self, n: int, device=None):
        super().__init__(n, device)
        self.acc = self._zeros()
        self.snapshot = self._zeros()
        self.stats = ClearStats(memory_multiplier=1, roundtrip_hops=1)

    def addto(self, q) -> None:
        self.acc = ops.sat_add(self.acc, self._q(q))

    def addto_batch(self, qs) -> None:
        """One launch per drained batch; monotone accumulation keeps
        lazy's no-clear contract (only the fold is batched)."""
        if len(qs):
            self.acc = ops.sat_add_batch(self.acc, self._stack(qs))

    def read_and_clear(self) -> torch.Tensor:
        ovf = is_sentinel(self.acc)
        # int32 difference, wrapping like the reference's int32 arrays
        diff = (self.acc.long() - self.snapshot.long()).to(torch.int32)
        delta = torch.where(ovf, torch.zeros_like(diff), diff)
        if bool(ovf.any()):
            # overflow fallback: host recomputes; switch memory resets
            self.stats.fallback_resets += 1
            self.acc = torch.zeros_like(self.acc)
            self.snapshot = torch.zeros_like(self.acc)
        else:
            self.snapshot = self.acc
        return delta


def make_clear_policy(policy: str, n: int, device=None):
    if policy == "copy":
        return CopyClear(n, device)
    if policy == "shadow":
        return ShadowClear(n, device)
    if policy == "lazy":
        return LazyClear(n, device)
    raise ValueError(f"clear policy must be one of {POLICIES}, got {policy!r}")

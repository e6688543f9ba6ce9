"""CntFwd: the counting/forwarding primitive (paper §4, §5.2.3), the port
of ``repro/core/agreement.py``.

Two realizations:

1. ON-DEVICE: quorum counters as a sum over the data-parallel ranks
   (``all_reduce`` over each mesh axis' group, the reference's masked
   psum): "forward when the counter reaches the threshold" becomes
   "commit the aggregated step when >= threshold workers contributed",
   the elastic-quorum commit gate of SyncAgtr.

2. HOST-LEVEL: counters in the INC map with threshold-gated forwarding —
   test&set (threshold 1) gives distributed locks; per-key vote maps give
   Paxos-style ballots.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.inc_map import ServerAgent


# -- on-device quorum (elastic SyncAgtr commit gate) -------------------------

def quorum_count(contributed: torch.Tensor, dp_axes) -> torch.Tensor:
    """contributed: per-rank {0,1} scalar -> global count (CntFwd counter),
    summed over the mesh axes ``dp_axes`` (``compat.Axis``)."""
    count = torch.as_tensor(contributed).to(torch.int32).clone()
    for ax in dp_axes:
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=ax.group)
    return count


def quorum_commit(count: torch.Tensor, threshold: int) -> torch.Tensor:
    """CntFwd gate: True once >= threshold ranks contributed."""
    return count >= threshold


def elastic_mean(x_sum: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Normalize a partial-quorum SUM by the live contributor count."""
    return x_sum / torch.clamp(count.to(x_sum.dtype), min=1)


# -- host-level CntFwd over the INC map ---------------------------------------

@dataclass
class CntFwd:
    """Threshold counters over INC-map keys (switch-resident when mapped).

    forward(key) semantics per Table 2:
        cnt[key] += 1; if cnt[key] == threshold: deliver and (optionally)
        clear; else drop.
    """
    server: ServerAgent
    threshold: int
    to: str = "ALL"
    delivered: dict[int, int] = field(default_factory=dict)

    def offer(self, key: int, votes: int = 1) -> bool:
        """Count a vote; True iff the threshold is reached by this packet."""
        self.server.addto_batch(np.array([key], np.uint32),
                                np.array([votes], np.int64))
        cnt = self.server.read(key)
        if cnt >= self.threshold and key not in self.delivered:
            self.delivered[key] = cnt
            return True
        return False

    def test_and_set(self, key: int) -> bool:
        """threshold=1 CntFwd == test&set: first caller wins (locks)."""
        prev = self.server.read(key)
        self.server.addto_batch(np.array([key], np.uint32),
                                np.array([1], np.int64))
        return prev == 0

    def release(self, key: int) -> None:
        cur = self.server.read(key)
        if cur:
            self.server.addto_batch(np.array([key], np.uint32),
                                    np.array([-cur], np.int64))
        self.delivered.pop(key, None)

"""repro_torch.net — the flip-bit transport on an actual wire (the port of
``repro/net``; the register file of its daemon lives on the card).

The in-process simulator (core/transport.py) proves the §5.1 protocol
logic; this package puts it across a real process boundary:

  - ``net.server``:  the switch daemon — owns ``SwitchMemory`` and the
    per-flow flip-bit arrays, speaks the length-prefixed frame protocol
    over loopback TCP or a Unix domain socket (``launch/switchd.py`` is
    the CLI entry point).
  - ``net.client``:  ``WireTransport`` (sliding window + AIMD against
    real ACKs, RTO retransmit timers, reconnect-and-replay, per-op
    deadlines) and ``RemoteSwitchMemory`` — a drop-in ``SwitchMemory``
    whose register file lives in the daemon, with a host-side fallback
    plane for graceful degradation.
  - ``net.faults``:  a deterministic frame-level fault proxy (seeded
    loss, duplication, reordering, delay, reset, crash windows).
  - ``net.protocol``: the frame layout and the op codec shared by both
    ends (GPV arrays fragmented into <= MTU frames, reassembled
    switch-side).
"""
from repro_torch.net.client import (RemoteSwitchMemory, WireError,
                                    WireTransport)
from repro_torch.net.faults import FaultProxy, FaultSpec
from repro_torch.net.server import SwitchServer

__all__ = ["FaultProxy", "FaultSpec", "RemoteSwitchMemory", "SwitchServer",
           "WireError", "WireTransport"]

"""The switch daemon as a process: ``python -m repro_torch.launch.switchd``.

Runs one ``repro_torch.net.SwitchServer`` in the foreground, its register
file on ``--device`` (the card unless ``--device cpu``; without a card it
raises), and prints a single machine-readable READY line so launchers can
scrape the bound address and where the registers live::

    SWITCHD READY {"host": "127.0.0.1", "port": 41623, "device": "cuda"}
    SWITCHD READY {"uds": "/tmp/switchd.sock", "device": "cuda"}

SIGTERM/SIGINT trigger a graceful shutdown: the daemon stops serving
(every connection closed, every handler joined), then spools the
register file and the per-flow idempotency arrays to ``--state-spool``
(when set) in the JAX package's layout, and a respawned daemon of either
package pointed at the same spool resumes with identical state — clients
reconnect and replay their in-flight window without a single
double-applied addTo. This SIGTERM+respawn cycle is the "switch restart"
fault of ``launch/elastic.py --wire-quorum``.

If an op raises while the daemon applies it (a kernel launch that fails,
say), the daemon stops without spooling, prints ``SWITCHD FAILED`` with
the traceback on stderr and exits 1: the op's seq was recorded, so a
silent retry would lose its effect.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from repro_torch.core.transport import W_MAX_DEFAULT
from repro_torch.net import SwitchServer
from repro_torch.net.protocol import MTU_DEFAULT


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.switchd",
        description="NetRPC switch daemon (real-wire data plane)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral; scrape the READY line)")
    ap.add_argument("--uds", default=None,
                    help="Unix socket path (overrides --host/--port)")
    ap.add_argument("--w-max", type=int, default=W_MAX_DEFAULT)
    ap.add_argument("--mtu", type=int, default=MTU_DEFAULT)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--slots", type=int, default=40_000,
                    help="slots per segment")
    ap.add_argument("--ecn-threshold", type=int, default=48)
    ap.add_argument("--state-spool", default=None,
                    help="pickle path: loaded on start if present, "
                         "written on graceful shutdown")
    ap.add_argument("--track-effects", action="store_true",
                    help="count per-(flow,seq) side-effect applications "
                         "(test/CI mode: proves exactly-once)")
    ap.add_argument("--device", default=None,
                    help="where the register file lives: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)

    srv = SwitchServer(host=args.host, port=args.port, uds_path=args.uds,
                       w_max=args.w_max, mtu=args.mtu,
                       n_segments=args.segments, seg_slots=args.slots,
                       ecn_threshold=args.ecn_threshold,
                       state_spool=args.state_spool,
                       track_effects=args.track_effects, device=args.device)
    done = threading.Event()

    def _term(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    srv.start()
    if isinstance(srv.address, str):
        ready = {"uds": srv.address}
    else:
        ready = {"host": srv.address[0], "port": srv.address[1]}
    ready["device"] = srv.switch.device.type
    print(f"SWITCHD READY {json.dumps(ready)}", flush=True)
    try:
        # a failed op stops the server on its own: poll for it beside the
        # signal
        while not done.wait(0.2) and srv.error is None:
            pass
    finally:
        srv.stop(spool=True)
        print(f"SWITCHD STOPPED {json.dumps(srv.stats)}", flush=True)
    if srv.error is not None:
        print(f"SWITCHD FAILED {srv.error}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

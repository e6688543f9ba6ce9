"""Elastic / fault-tolerant training driver (cluster-scale contract demo),
the port of ``repro/launch/elastic.py``.

Simulates the failure modes a 1000-node deployment must survive and shows
the framework's answers:

  preemption + restart   checkpoint/restart with the step-parity
                         exactly-once gate (a re-executed step is detected
                         as a "retransmission" and skipped — the paper's
                         flip-bit idempotency at cluster scale);
  straggler mitigation   CntFwd elastic quorum: a step commits when
                         >= quorum x n_dp workers contributed; the
                         aggregated sum is normalized by the live count
                         (paper §4: "forward when the counter reaches the
                         threshold", used as a partial-aggregation gate),
                         on a ``compat.make_mesh`` group of the ranks
                         there are (one on one card);

  real-wire quorum       CntFwd votes cast by *real client subprocesses*
                         over the loopback switch daemon (repro_torch.net,
                         its register file on the card), with packet loss
                         injected and the daemon SIGTERM'd and respawned
                         mid-run — the same straggler/commit contract, but
                         across genuine process and socket boundaries
                         (``--wire-quorum``). Every vote and gradient
                         element must land exactly once, and no worker may
                         degrade onto its local fallback plane.

Everything runs on ``--device`` (the card unless ``--device cpu``; without
a card it raises), the daemon and the worker subprocesses included.

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch qwen2.5-3b \\
        --steps 40 --kill-at 20
    PYTHONPATH=src python -m repro_torch.launch.elastic --wire-quorum
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading

# Geometry shared by the daemon and every client mirror in the
# wire-quorum demo, the reference's by default (RESERVE replies carry it;
# a mismatch is an error).
_WIRE_SEGMENTS = 4
_WIRE_SEG_SLOTS = 2048
_VOTE_GAID = 101                   # per-step CntFwd vote counters
_GRAD_GAID = 102                   # shared gradient accumulator


def run(arch: str, steps_n: int, kill_at: int, ckpt_dir: str,
        device=None) -> dict:
    from repro_torch.launch.train import train_loop
    # phase 1: train until the simulated preemption
    print(f"=== phase 1: train to step {kill_at}, then 'preempt' ===")
    out1 = train_loop(arch=arch, inc_mode="netrpc", steps_n=kill_at,
                      seq=64, batch=8, reduced=True, ckpt_dir=ckpt_dir,
                      ckpt_every=5, resume=False, device=device)
    # phase 2: restart from the latest checkpoint; the loop's
    # already_applied() gate skips any step whose effects are persisted
    print("=== phase 2: restart, resume from checkpoint ===")
    out2 = train_loop(arch=arch, inc_mode="netrpc", steps_n=steps_n,
                      seq=64, batch=8, reduced=True, ckpt_dir=ckpt_dir,
                      ckpt_every=5, resume=True, device=device)
    print(f"pre-kill last loss {out1['losses'][-1]:.4f}; "
          f"post-restart final {out2['losses'][-1]:.4f}")
    return {"phase1": out1["losses"], "phase2": out2["losses"]}


def quorum_demo(n_dp: int = 8, quorum: float = 0.75, device=None) -> list:
    """Straggler mitigation over the data ranks there are: drop workers,
    commit anyway. Each rank contributes ``rank + 1``; returns the
    (alive, count, commit, elastic mean) of each round."""
    import torch
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.core.agreement import (elastic_mean, quorum_commit,
                                            quorum_count)
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import one_rank_group

    dev = resolve_device(device)
    rows = []
    with one_rank_group(dev):
        mesh = compat.make_mesh((dist.get_world_size(),), ("data",),
                                device=dev)
        axes = mesh.axes_of(("data",))
        n = compat.axis_size(axes[0])
        me = compat.axis_index(axes[0])
        grad = torch.tensor(me + 1.0, device=dev)
        for alive in (n, max(1, int(n * 0.9)), max(1, int(n * 0.5))):
            contrib = torch.tensor(float(me < alive), device=dev)
            cnt = quorum_count(contrib, axes)
            commit = quorum_commit(cnt, int(quorum * n))
            total = torch.where(contrib > 0, grad, 0.0)
            for ax in axes:
                dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ax.group)
            mean = torch.where(commit, elastic_mean(total, cnt), 0.0)
            rows.append((alive, int(cnt), bool(commit), float(mean)))
            print(f"alive {alive}/{n}: count={int(cnt)} "
                  f"commit={bool(commit)} elastic_mean={float(mean):.3f}")
    return rows


def _worker_grads(worker_id: int, steps: int, grad_slots: int):
    """Deterministic per-(worker, step) gradient contributions, so the
    orchestrator can recompute the expected switch state without IPC."""
    import numpy as np
    rng = np.random.default_rng(1000 + worker_id)
    return [rng.integers(-100, 100, size=grad_slots).astype(np.int32)
            for _ in range(steps)]


def wire_worker(addr: str, worker_id: int, n_workers: int, steps: int,
                grad_slots: int, quorum: float, device=None,
                segments: int = _WIRE_SEGMENTS,
                seg_slots: int = _WIRE_SEG_SLOTS) -> None:
    """One data-plane client process: contribute gradients and cast a
    CntFwd vote per step over the real wire, printing a HALF marker (the
    orchestrator restarts the daemon on it) and a DONE line with the
    observed commits and the flow's report."""
    import numpy as np

    from repro_torch.net import RemoteSwitchMemory, WireTransport

    host, _, port = addr.rpartition(":")
    # workers must ride out the planned daemon restart (a cold python +
    # torch respawn), so the degradation threshold sits well above it
    t = WireTransport((host, int(port)), flow_id=10 + worker_id, w_max=8,
                      rto_base=0.05, call_timeout=120.0,
                      unreachable_after=120.0)
    mem = RemoteSwitchMemory(t, n_segments=segments, seg_slots=seg_slots,
                             device=device)
    try:
        if not (mem.reserve(_VOTE_GAID, steps)
                and mem.reserve(_GRAD_GAID, grad_slots)):
            raise RuntimeError("the switch refused a partition")
        vstart = mem.partitions[_VOTE_GAID][0]
        gstart = mem.partitions[_GRAD_GAID][0]
        gphys = gstart + np.arange(grad_slots, dtype=np.int64)
        threshold = max(1, int(round(quorum * n_workers)))
        commits = []
        for s, vals in enumerate(_worker_grads(worker_id, steps,
                                               grad_slots)):
            mem.addto(gphys, vals)
            mem.addto(np.array([vstart + s], np.int64),
                      np.array([1], np.int32))          # the CntFwd vote
            cnt = int(mem.get(np.array([vstart + s], np.int64))[0])
            commits.append(cnt >= threshold)
            if s == max(0, steps // 2 - 1):
                print(f"WIREWORKER {worker_id} HALF", flush=True)
        rep = mem.report()
        print("WIREWORKER %d DONE %s" % (worker_id, json.dumps(
            {"commits": commits,
             "retx": rep["retx"], "reconnects": rep["reconnects"],
             "degraded": rep["degraded"],
             "fallback_active": rep["fallback_active"],
             "fallback_activations": rep["fallback_activations"]})),
            flush=True)
    finally:
        t.close()


def _child_env() -> dict:
    """Environment for spawned daemon/worker processes: make sure the
    ``repro_torch`` package the orchestrator imported is importable there
    too."""
    import repro_torch
    env = dict(os.environ)
    src = os.path.dirname(list(repro_torch.__path__)[0])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn_switchd(uds: str, spool: str, device: str, segments: int,
                   seg_slots: int) -> subprocess.Popen:
    """Start ``repro_torch.launch.switchd`` on ``uds`` with its registers
    on ``device`` ("cuda" or "cpu") and wait for its READY line; fails
    unless the daemon says they live there."""
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.switchd", "--uds", uds,
         "--segments", str(segments), "--slots", str(seg_slots),
         "--state-spool", spool, "--track-effects", "--device", device],
        stdout=subprocess.PIPE, text=True, env=_child_env())
    line = p.stdout.readline()
    if "SWITCHD READY" not in line:
        p.kill()
        raise RuntimeError(f"switchd failed to start: {line!r}")
    ready = json.loads(line.split("SWITCHD READY", 1)[1])
    if ready.get("device") != device:
        p.kill()
        raise RuntimeError(f"switchd registers on {ready.get('device')}, "
                           f"asked for {device}")
    return p


def _stop_switchd(daemon: subprocess.Popen, what: str) -> None:
    """SIGTERM the daemon and wait; fails unless it exits 0 (an op that
    raised in the daemon makes it exit 1)."""
    daemon.send_signal(signal.SIGTERM)
    rc = daemon.wait(timeout=60)
    if rc != 0:
        raise RuntimeError(f"switchd exited rc={rc} at {what}")


def wire_quorum(n_workers: int = 2, steps: int = 6, grad_slots: int = 64,
                loss: float = 0.05, restart: bool = True,
                quorum: float = 1.0, workdir: str | None = None,
                device=None, segments: int = _WIRE_SEGMENTS,
                seg_slots: int = _WIRE_SEG_SLOTS) -> dict:
    """CntFwd quorum across real subprocesses: a switch daemon, a lossy
    proxy, and ``n_workers`` client processes voting per step. Midway,
    SIGTERM the daemon and respawn it from its state spool; every vote
    and gradient element must still land exactly once. ``workdir`` holds
    the daemon's socket and spool (a new temporary directory, removed
    after, by default)."""
    import numpy as np

    from repro_torch.kernels.backend import resolve_device
    from repro_torch.net import FaultProxy, FaultSpec, RemoteSwitchMemory, \
        WireTransport

    device = resolve_device(device).type      # raises without a card
    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="wq") if own_dir else workdir
    uds = os.path.join(workdir, f"wirequorum_{os.getpid()}.sock")
    spool = os.path.join(workdir, f"wirequorum_{os.getpid()}.pkl")
    for path in (uds, spool):
        if os.path.exists(path):
            os.unlink(path)
    daemon = _spawn_switchd(uds, spool, device, segments, seg_slots)
    proxy = FaultProxy(uds, FaultSpec(seed=11, loss=loss, dup=loss / 2,
                                      reorder=loss / 2)).start()
    addr = f"{proxy.address[0]}:{proxy.address[1]}"

    env = _child_env()
    halves = [threading.Event() for _ in range(n_workers)]
    outputs: list[list[str]] = [[] for _ in range(n_workers)]

    def _drain(ix: int, pipe) -> None:
        for line in pipe:
            line = line.strip()
            outputs[ix].append(line)
            if line.endswith("HALF"):
                halves[ix].set()

    workers, drains = [], []
    try:
        for k in range(n_workers):
            w = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.elastic",
                 "--wire-worker", "--addr", addr, "--worker-id", str(k),
                 "--n-workers", str(n_workers), "--wire-steps", str(steps),
                 "--grad-slots", str(grad_slots), "--quorum", str(quorum),
                 "--device", device, "--wire-segments", str(segments),
                 "--wire-slots", str(seg_slots)],
                stdout=subprocess.PIPE, text=True, env=env)
            th = threading.Thread(target=_drain, args=(k, w.stdout),
                                  daemon=True)
            th.start()
            workers.append(w)
            drains.append(th)

        if restart:
            for ev in halves:
                if not ev.wait(timeout=120):
                    raise RuntimeError("worker never reached HALF")
            _stop_switchd(daemon, "the mid-run restart")
            daemon = _spawn_switchd(uds, spool, device, segments, seg_slots)
            print("=== switch daemon restarted mid-run ===", flush=True)

        for w in workers:
            if w.wait(timeout=300) != 0:
                raise RuntimeError(f"wire worker exited rc={w.returncode}")
        for th in drains:
            th.join(timeout=10)

        # verify against a clean (fault-free) read of the daemon state
        t = WireTransport(uds, flow_id=99, w_max=8, call_timeout=30.0)
        mem = RemoteSwitchMemory(t, n_segments=segments, seg_slots=seg_slots,
                                 device=device)
        try:
            if not (mem.reserve(_VOTE_GAID, steps)
                    and mem.reserve(_GRAD_GAID, grad_slots)):
                raise RuntimeError("the switch refused a partition")
            vstart = mem.partitions[_VOTE_GAID][0]
            gstart = mem.partitions[_GRAD_GAID][0]
            votes = mem.get(vstart + np.arange(steps, dtype=np.int64))
            grads = mem.get(gstart + np.arange(grad_slots, dtype=np.int64))
            stats = t.ctrl("stats")
            checker_fell_back = mem.fallback_activations
        finally:
            t.close()

        expect = np.zeros(grad_slots, dtype=np.int64)
        for k in range(n_workers):
            for vals in _worker_grads(k, steps, grad_slots):
                expect += vals
        done = [json.loads(line.split("DONE ", 1)[1])
                for out in outputs for line in out if " DONE " in line]
        if len(done) != n_workers:
            raise RuntimeError(f"{len(done)} of {n_workers} workers "
                               f"reported DONE")
        committed = [any(d["commits"][s] for d in done)
                     for s in range(steps)]
        result = {
            "votes": votes.tolist(),
            "votes_exact": bool((votes == n_workers).all()),
            "grads_exact": bool(
                (grads.astype(np.int64) == expect).all()),
            "steps_committed": sum(committed),
            "steps": steps,
            "duplicate_effects": stats["duplicate_effects"],
            "worker_retx": [d["retx"] for d in done],
            "worker_reconnects": [d["reconnects"] for d in done],
            "degraded": [d["degraded"] or d["fallback_active"]
                         or d["fallback_activations"] > 0 for d in done]
            + [checker_fell_back > 0],
            "device": device,
        }
        print(f"wire quorum: votes={result['votes']} "
              f"exact={result['votes_exact']}/{result['grads_exact']} "
              f"committed={result['steps_committed']}/{steps} "
              f"dupes={result['duplicate_effects']} "
              f"retx={result['worker_retx']} "
              f"reconnects={result['worker_reconnects']} "
              f"device={device}", flush=True)
        if any(result["degraded"]):
            raise RuntimeError(f"a flow degraded onto its local fallback "
                               f"plane: {result}")
        if not (result["votes_exact"] and result["grads_exact"]):
            raise RuntimeError(f"wire quorum state diverged: {result}")
        if result["steps_committed"] != steps:
            raise RuntimeError(f"quorum never committed: {result}")
        if result["duplicate_effects"]:
            raise RuntimeError(
                f"double-applied effects: {result['duplicate_effects']}")
        _stop_switchd(daemon, "the end")
        return result
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
        proxy.stop()
        if daemon.poll() is None:
            daemon.send_signal(signal.SIGTERM)
            try:
                daemon.wait(timeout=15)
            except subprocess.TimeoutExpired:
                daemon.kill()
        for path in (uds, spool):
            if os.path.exists(path):
                os.unlink(path)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--kill-at", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one, removed after)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; the daemon and the "
                         "worker processes run there too")
    ap.add_argument("--wire-quorum", action="store_true",
                    help="run the real-subprocess CntFwd quorum demo "
                         "instead of the training demo")
    ap.add_argument("--wire-workers", type=int, default=2)
    ap.add_argument("--wire-steps", type=int, default=6)
    ap.add_argument("--wire-loss", type=float, default=0.05)
    ap.add_argument("--wire-segments", type=int, default=_WIRE_SEGMENTS,
                    help="register segments of the daemon")
    ap.add_argument("--wire-slots", type=int, default=_WIRE_SEG_SLOTS,
                    help="slots per segment of the daemon")
    ap.add_argument("--grad-slots", type=int, default=64,
                    help="gradient elements each worker adds a step")
    ap.add_argument("--no-restart", action="store_true",
                    help="skip the mid-run daemon restart")
    ap.add_argument("--quorum", type=float, default=1.0)
    # internal: worker mode (spawned by wire_quorum)
    ap.add_argument("--wire-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--addr", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--n-workers", type=int, default=2,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.wire_worker:
        wire_worker(args.addr, args.worker_id, args.n_workers,
                    args.wire_steps, args.grad_slots, args.quorum,
                    device=args.device, segments=args.wire_segments,
                    seg_slots=args.wire_slots)
        return
    if args.wire_quorum:
        wire_quorum(n_workers=args.wire_workers, steps=args.wire_steps,
                    grad_slots=args.grad_slots, loss=args.wire_loss,
                    restart=not args.no_restart, quorum=args.quorum,
                    device=args.device, segments=args.wire_segments,
                    seg_slots=args.wire_slots)
        return
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="elastic_ckpt")
    try:
        run(args.arch, args.steps, args.kill_at, ckpt_dir,
            device=args.device)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    quorum_demo(device=args.device)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

1. Build: every CUDA kernel of the path, from the sources in the checkout
   (one nvcc per source, in parallel); prints the card and the build time.
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the path's shapes (a 40 000-slot segment, dense n=40 000, scatter
   k=65 536 with duplicates and saturating values); exact for ints and
   masks, bitwise for fp32. Times each one and its bound.
3. Path: the typed INC RPC round trip through ``IncRuntime()`` on the
   default device, at the paper's switch geometry (32 x 40 000 int32), two
   workers over four rounds of five services; replies checked against a
   numpy fixed-point oracle, and replies and register state held bitwise
   against the same run with ``device="cpu"``. Launch counts are reset
   just before the card run and read just after it.

Prints the card's name and power limit, one JSON line of kernel results,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, at the first failure or when no CUDA device is present.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
SEG = 40_000                   # slots per register segment (paper §6.1)
SCATTER_K = 65_536
PRECISION = 8
WORKERS, ROUNDS = 2, 4
# (label, partition slots, gradient length, device-resident, service)
PHASES = (("a_dense_one_segment", 40_000, 40_000, True, "grad"),
          ("b_dense_seven_segments", 262_144, 262_144, True, "grad"),
          ("c_quickstart_cntfwd", 65_536, 65_536, True, "quickstart"),
          ("d_host_lane", 262_144, 262_144, False, "grad"),
          ("e_spill_regrant", 131_072, 262_144, True, "grad"))
REPLACES = {
    "fused_addto": "src/repro/kernels/fused_gpv.py:67",
    "fused_scatter": "src/repro/kernels/fused_gpv.py:113",
    "fused_read": "src/repro/kernels/fused_gpv.py:189",
    "sparse_addto": "src/repro/kernels/sparse_addto.py:38",
}
SOURCE = {
    "fused_addto": "src/repro_torch/kernels/csrc/fused_gpv.cu",
    "fused_scatter": "src/repro_torch/kernels/csrc/fused_gpv.cu",
    "fused_read": "src/repro_torch/kernels/csrc/fused_gpv.cu",
    "sparse_addto": "src/repro_torch/kernels/csrc/sparse_addto.cu",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- timing -------------------------------------------------------------------

def device_ms(torch, fn, reset, iters: int) -> tuple[float, str]:
    """Mean device time of ``fn`` per call: the CUDA time of this
    package's kernels (``inc_k_*``) under the profiler, or, if the
    profiler records no device time, CUDA events around each call."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        reset()
        fn()
    torch.cuda.synchronize()
    us = 0.0
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                reset()
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "inc_k_" in ev.key:
                us += getattr(ev, "device_time_total",
                              getattr(ev, "cuda_time_total", 0.0))
    except RuntimeError as e:         # no CUPTI in this sandbox: use events
        print(f"profiler unavailable ({e}); timing with CUDA events",
              flush=True)
    if us > 0:
        return us / iters / 1e3, "cupti"
    return event_ms(torch, fn, reset, iters), "events"


def event_ms(torch, fn, reset, iters: int) -> float:
    """Median of CUDA-event times around single calls (host dispatch
    included); ``reset`` runs outside the timed window."""
    times = []
    for i in range(iters + 2):
        reset()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        if i >= 2:
            times.append(s.elapsed_time(e))
    return statistics.median(times)


# -- phase 2: kernels against their plain versions ----------------------------

def kernel_inputs(rng):
    """Segment registers, a dense fp32 stream and a k=65 536 scatter at
    the path's shapes: gradient-sized values, hot duplicate slots, a few
    sentinels and saturating updates."""
    regs = rng.randint(-10 ** 7, 10 ** 7, SEG).astype(np.int32)
    regs[rng.choice(SEG, 8, replace=False)] = [2 ** 31 - 1, -(2 ** 31 - 1),
                                               2 ** 31 - 2, -(2 ** 31 - 2),
                                               -2 ** 31, 0, 2 ** 30, -2 ** 30]
    dense = (rng.randn(SEG) * 0.05).astype(np.float32)
    dense[:4] = [2.0 ** 31 / 1e8, -2.0 ** 31 / 1e8, 0.5e-8, 1.5e-8]
    idx = rng.randint(0, SEG, SCATTER_K).astype(np.int32)
    idx[:8192] = rng.randint(0, 256, 8192)                 # hot duplicates
    ivals = rng.randint(-10 ** 6, 10 ** 6, SCATTER_K).astype(np.int32)
    sat = rng.choice(SCATTER_K, 512, replace=False)
    ivals[sat] = 2 ** 30                                   # saturating
    fvals = (rng.randn(SCATTER_K) * 0.05).astype(np.float32)
    fvals[sat] = 12.0                                      # 1.2e9 each
    return regs, dense, idx, ivals, fvals


def check_kernels(torch) -> list[dict]:
    from repro_torch.kernels import fused_gpv, sparse_addto
    dev = torch.device("cuda")
    rng = np.random.RandomState(1234)
    regs_np, dense_np, idx_np, ivals_np, fvals_np = kernel_inputs(rng)
    regs0 = torch.from_numpy(regs_np).to(dev)
    dense = torch.from_numpy(dense_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    ivals = torch.from_numpy(ivals_np).to(dev)
    fvals = torch.from_numpy(fvals_np).to(dev)
    scale = 10 ** PRECISION
    regs = regs0.clone()

    def reset():
        regs.copy_(regs0)

    def same_int(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"{name}: {bad} registers differ from the plain version")

    cases = {
        "fused_addto": (lambda: fused_gpv.fused_addto(regs, 0, dense, scale),
                        lambda: fused_gpv.fused_addto_plain(regs, 0, dense,
                                                            scale),
                        12 * SEG),
        "fused_scatter": (lambda: fused_gpv.fused_scatter(regs, idx, fvals,
                                                          scale),
                          lambda: fused_gpv.fused_scatter_plain(
                              regs, idx, fvals, scale), None),
        "fused_read": (lambda: fused_gpv.fused_read(regs, 0, SEG, scale),
                       lambda: fused_gpv.fused_read_plain(regs, 0, SEG,
                                                          scale),
                       9 * SEG),
        "sparse_addto": (lambda: sparse_addto.sparse_addto(regs, idx, ivals),
                         lambda: sparse_addto.sparse_addto_plain(
                             regs, idx, ivals), None),
    }
    touched = len(np.unique(idx_np))
    scatter_bytes = SCATTER_K * 8 + touched * 8
    out = []
    for name, (kernel, plain, nbytes) in cases.items():
        reset()
        got = kernel()
        got = tuple(t.clone() for t in got) if isinstance(got, tuple) \
            else got.clone()
        reset()
        want = plain()
        if name == "fused_read":
            same_int(name, got[0].view(torch.int32),
                     want[0].view(torch.int32))
            same_int(name + " mask", got[1], want[1])
            err = float((got[0] - want[0]).abs().max())
        else:
            same_int(name, got, want)
            err = float((got.long() - want.long()).abs().max())
        ms, timer = device_ms(torch, kernel, reset, 50)
        plain_ms = event_ms(torch, plain, reset, 5)
        nbytes = nbytes if nbytes is not None else scatter_bytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name}: ok vs plain, ms={ms:.6f} ({timer}) "
              f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}", flush=True)
        out.append({"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name], "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": None, "timer": timer})
    return out


# -- phase 3: the main path ---------------------------------------------------

def services(inc):
    from repro_torch.quickstart import Gradient as Quickstart
    made = {}

    def grad(app, device):
        @inc.service(app=app, drain=inc.DrainPolicy(
            max_batch=WORKERS, max_delay=60.0, eager_window=False))
        class Grad:
            @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad")
            def Update(self, tensor: inc.Agg[inc.FPArray](
                    precision=PRECISION, clear="copy", device=device)
                    ) -> {"tensor": inc.Get[inc.FPArray]}: ...
        return Grad

    for label, _, _, device, kind in PHASES:
        made[label] = (Quickstart if kind == "quickstart"
                       else grad(f"grad-{label}", device))
    return made


def gradients(label: str, n: int) -> np.ndarray:
    """(ROUNDS, WORKERS, n) fp32 gradients from a seed; the spill phase's
    are sparse (exact zeros), so clear write-backs skew the LRU counts and
    force re-grants of non-contiguous slots."""
    rng = np.random.RandomState(sum(map(ord, label)))
    g = (rng.randn(ROUNDS, WORKERS, n) * 0.05).astype(np.float32)
    if label.startswith("e_"):
        g[rng.rand(ROUNDS, WORKERS, n) < 0.5] = 0.0
    return g


def oracle(g: np.ndarray, kind: str, device_lane: bool) -> list:
    """Expected replies: the fixed-point contributions the switch holds
    at each Get, dequantized as the lane does it (fp32 reciprocal on the
    device lane, ``raw / scale`` in float64 on the host lane)."""
    scale = 10 ** PRECISION
    q = np.rint(g * np.float32(scale)).astype(np.int64)

    def deq(raw):
        if device_lane:
            return raw.astype(np.float32) * (np.float32(1.0)
                                             / np.float32(scale))
        return raw / scale

    want = []
    for r in range(ROUNDS):
        if kind == "quickstart":      # CntFwd: only the quorum call replies
            want += [None, deq(q[r, 0] + q[r, 1])]
        else:                         # clear="copy": each call's own part
            want += [deq(q[r, w]) for w in range(WORKERS)]
    return want


def same(a, b) -> bool:
    """Both absent, or arrays of one dtype and shape, finite and equal
    bit for bit."""
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(np.isfinite(a).all()) and a.tobytes() == b.tobytes())


def drive_path(device, *, seg_slots=SEG, scale_down=1):
    """Every phase through the port's public entry points on ``device``;
    returns (replies, switch state_dict, launches, seconds), the last
    three per phase."""
    import repro_torch.api as inc
    from repro_torch.core.channel import Controller
    from repro_torch.core.inc_map import SwitchMemory
    from repro_torch.kernels import ops
    svcs = services(inc)
    rt = inc.IncRuntime(device=device) if seg_slots == SEG else \
        inc.IncRuntime(controller=Controller(
            switch=SwitchMemory(32, seg_slots, device=device)))
    replies, launches, seconds = {}, {}, {}
    try:
        for label, slots, n, dev_lane, kind in PHASES:
            slots, n = slots // scale_down, n // scale_down
            before = ops.launch_counts()
            t0 = time.perf_counter()
            stubs = [rt.make_stub(svcs[label], n_slots=slots)
                     for _ in range(WORKERS)]
            g = gradients(label, n)
            got = []
            for r in range(ROUNDS):
                futs = [s.Update(tensor=g[r, w]) for w, s in enumerate(stubs)]
                for f in futs:
                    rep = f.result(timeout=600)
                    t = rep.get("tensor")
                    got.append(None if t is None else
                               t.cpu().numpy() if hasattr(t, "cpu") else t)
            seconds[label] = time.perf_counter() - t0
            want = oracle(g, kind, dev_lane)
            for i, (a, b) in enumerate(zip(got, want)):
                if not same(a, b):
                    fail(f"{label}: reply {i} on {device} disagrees with the "
                         f"fixed-point oracle")
            replies[label] = got
            after = ops.launch_counts()
            launches[label] = {k: after[k] - before[k] for k in after}
        state = rt.controller.switch.state_dict()
    finally:
        rt.close()
    return replies, state, launches, seconds


def check_path(torch) -> dict:
    from repro_torch.kernels import ops
    ops.reset_counts()
    t0 = time.perf_counter()
    replies, state, per_phase, secs = drive_path(None)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    for label, c in per_phase.items():
        print(f"path {label}: {secs[label]:.3f} s for {ROUNDS} rounds of "
              f"{WORKERS} calls, launches {c}", flush=True)
    print(f"path on the card: {card_s:.3f} s, launches {counts}", flush=True)
    t0 = time.perf_counter()
    ref_replies, ref_state, _, _ = drive_path("cpu")
    print(f"path on the CPU (reference): {time.perf_counter() - t0:.3f} s",
          flush=True)
    for label in replies:
        for i, (a, b) in enumerate(zip(replies[label], ref_replies[label])):
            if not same(a, b):
                fail(f"{label}: reply {i} differs between card and CPU")
    if state["partitions"] != ref_state["partitions"]:
        fail("partition tables differ between card and CPU")
    for s, (a, b) in enumerate(zip(state["regs"], ref_state["regs"])):
        if not torch.equal(a, b):
            fail(f"segment {s}: registers differ between card and CPU")
    print("path: replies and registers bitwise equal to the CPU run",
          flush=True)
    for name in ("fused_addto", "fused_read", "sparse_addto", "fused_scatter"):
        if counts[name] == 0:
            fail(f"the path never launched {name}")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    each = ", ".join(f"{k} {v:.1f} s" for k, v in built.items())
    print(f"build: {time.perf_counter() - t0:.1f} s ({each or 'cached'})",
          flush=True)
    kernels = check_kernels(torch)
    counts = check_path(torch)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        print(f"kernel {k['name']}: ms={k['ms']:.6f} "
              f"plain_ms={k['plain_ms']:.6f} bound_ms={k['bound_ms']:.6f} "
              f"launches={k['launches']}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

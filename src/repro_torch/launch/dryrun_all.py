"""The sweep: every (arch x shape x mesh) dry-run cell in a subprocess
(each starts its own fake world), the port of
``repro/launch/dryrun_all.py``. Each cell's result lands in
``<outdir>/<arch>__<shape>__<mesh>__<inc_mode>.json``; a cell already
there as ok or skipped is not run again.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all \\
        [--mesh single multi] [--arch ...] [--shape ...] [--jobs 3]
        [--inc-mode netrpc] [--flash] [--outdir build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ARCHS = (
    "moonshot-v1-16b-a3b", "grok-1-314b", "gemma3-27b", "phi4-mini-3.8b",
    "stablelm-1.6b", "qwen2.5-3b", "llama-3.2-vision-90b",
    "recurrentgemma-9b", "mamba2-780m", "whisper-medium",
)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def run_one(arch: str, shape: str, mesh: str, inc_mode: str, outdir: Path,
            timeout: int, extra: list[str]) -> dict:
    out = outdir / f"{arch}__{shape}__{mesh}__{inc_mode}.json"
    if out.exists():
        res = json.loads(out.read_text())
        if res.get("status") in ("ok", "skipped"):
            return res
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[2])
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--inc-mode", inc_mode,
           "--json", str(out)] + extra
    t0 = time.time()
    try:
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=timeout)
        if not out.exists():
            res = {"arch": arch, "shape": shape, "mesh": mesh,
                   "inc_mode": inc_mode, "status": "error",
                   "error": (p.stderr or p.stdout)[-2000:]}
            out.write_text(json.dumps(res, indent=2))
        res = json.loads(out.read_text())
    except subprocess.TimeoutExpired:
        res = {"arch": arch, "shape": shape, "mesh": mesh,
               "inc_mode": inc_mode, "status": "timeout",
               "wall_s": time.time() - t0}
        out.write_text(json.dumps(res, indent=2))
    res["wall_s"] = round(time.time() - t0, 1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", nargs="*", default=["single", "multi"])
    ap.add_argument("--inc-mode", default="netrpc")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--outdir", default="build/dryrun")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--flash", action="store_true")
    args = ap.parse_args(argv)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    extra = []
    if args.n_micro:
        extra += ["--n-micro", str(args.n_micro)]
    if args.flash:
        extra += ["--flash"]

    cells = [(a, s, m) for a in args.arch for s in args.shape
             for m in args.mesh]
    results = []
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = {ex.submit(run_one, a, s, m, args.inc_mode, outdir,
                          args.timeout, extra): (a, s, m)
                for a, s, m in cells}
        for done, (fut, key) in enumerate(futs.items(), 1):
            res = fut.result()
            line = (f"[{done}/{len(cells)}] {key[0]:22s} {key[1]:12s} "
                    f"{key[2]:6s} -> {res['status']:8s} "
                    f"({res.get('wall_s', 0):.0f}s, trace "
                    f"{res.get('trace_s', '-')}s)")
            if res["status"] == "ok":
                line += (f" {res['dominant']}, roofline fraction "
                         f"{res['roofline_fraction']:.6f}, peak "
                         f"{res['peak_bytes'] / 2 ** 30:.3f} GiB a rank, "
                         f"{'fits' if res['fits'] else 'does not fit'}")
            print(line, flush=True)
            results.append(res)

    bad = [r for r in results if r["status"] not in ("ok", "skipped")]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells ok/skipped; "
          f"{len(bad)} failed")
    for r in bad:
        print("FAILED:", r["arch"], r["shape"], r["mesh"],
              str(r.get("error", ""))[:200])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

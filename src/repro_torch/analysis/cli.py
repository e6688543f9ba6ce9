"""Command-line front end: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean (baselined/suppressed findings are clean); 1 at
least one non-baselined finding; 2 stale baseline entries or a broken
baseline file. CI treats anything nonzero as a failed lane.

Departure from ``repro.analysis.cli``: with no path it scans the
``repro_torch`` package it belongs to (``src/repro_torch`` in a
checkout) wherever it runs from, and the baseline it finds by walking up
is ``scripts/planelint_torch_baseline.json``.
"""
from __future__ import annotations

import argparse
import os
import sys

import repro_torch.analysis as planelint
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.rules import RULES


# the repro_torch package this analyzer belongs to
DEFAULT_PATH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _find_default_baseline(paths) -> str | None:
    """Walk up from the first scanned path, then the cwd, looking for
    the committed baseline so invocations from any directory agree."""
    starts = [os.path.abspath(paths[0]) if paths else os.getcwd(),
              os.getcwd()]
    for start in starts:
        cur = start if os.path.isdir(start) else os.path.dirname(start)
        for _ in range(8):
            cand = os.path.join(cur, planelint.DEFAULT_BASELINE)
            if os.path.exists(cand):
                return cand
            nxt = os.path.dirname(cur)
            if nxt == cur:
                break
            cur = nxt
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="planelint: plane-invariant static analyzer")
    ap.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                    help="files or directories to scan (default "
                         "src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: auto-discover "
                         f"{planelint.DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="write all current findings as a baseline "
                         "skeleton to PATH and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, (_, desc) in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    paths = args.paths or [DEFAULT_PATH]
    if args.write_baseline:
        findings, _, _, errors = planelint.analyze_paths(paths)
        for err in errors:
            print(f"planelint: parse error: {err}", file=sys.stderr)
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            fh.write(baseline_mod.dump(findings))
        print(f"planelint: wrote {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} to "
              f"{args.write_baseline} — fill in each 'reason'")
        return 0

    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or _find_default_baseline(paths)
    try:
        res = planelint.run(paths, baseline_path)
    except baseline_mod.BaselineError as e:
        print(f"planelint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(planelint.format_json(res["new"], res["stale"]))
    else:
        print(planelint.format_text(
            res["new"], res["stale"], suppressed=res["suppressed"],
            baselined=len(res["baselined"]), files=res["files"]))
    for err in res["errors"]:
        print(f"planelint: parse error: {err}", file=sys.stderr)
    if res["new"] or res["errors"]:
        return 1
    if res["stale"]:
        return 2
    return 0

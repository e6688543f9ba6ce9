"""planelint — the plane-invariant static analyzer (stdlib-ast only),
the port's copy of ``repro.analysis``.

Checks the data-plane concurrency/observability contract of the port
mechanically (see docs/ANALYSIS.md for the rule catalog, which is the
same here):

    python -m repro_torch.analysis src/repro_torch  # make lint-plane-torch

Zero third-party dependencies by design: the package imports only the
standard library and itself (no torch), asserted by
tests/test_torch_analysis.py, so the lint gate runs on a stock Python
with no environment at all.

The rules, messages, pragmas, finding keys, output and exit codes are
the reference's. Each departure reads the port's idiom and is named in
its module: the obs package (``visitor``), the path anchor
(``findings``), L1's mutation vocabulary (``rules``), the ExitStack
locks (``lockmodel``), and the default path and baseline (``cli``,
``DEFAULT_BASELINE`` here).
"""
from __future__ import annotations

import os

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.findings import Finding, canon_path, format_json, \
    format_text
from repro_torch.analysis.rules import RULES, run_rules
from repro_torch.analysis.visitor import ModuleInfo

__all__ = [
    "Finding", "ModuleInfo", "RULES", "analyze_source", "analyze_paths",
    "canon_path", "format_json", "format_text", "run",
]

DEFAULT_BASELINE = "scripts/planelint_torch_baseline.json"


def analyze_source(source: str, path: str = "src/repro_torch/fixture.py",
                   only: set | None = None) -> list:
    """Findings for one in-memory module (pragmas applied) — the test
    fixture entry point."""
    mod = ModuleInfo(path, source)
    return _apply_pragmas(mod, run_rules(mod, only))[0]


def _apply_pragmas(mod: ModuleInfo, findings: list):
    kept, suppressed = [], 0
    for f in findings:
        if mod.suppressions.allows(f.rule, f.line):
            suppressed += 1
        else:
            kept.append(f)
    kept.extend(mod.suppressions.malformed)
    return kept, suppressed


def iter_py_files(paths):
    for path in paths:
        if os.path.isfile(path):
            yield path
        else:
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def analyze_paths(paths, only: set | None = None):
    """-> (findings, n_suppressed, n_files, parse_errors)."""
    findings, suppressed, n_files, errors = [], 0, 0, []
    for path in iter_py_files(paths):
        n_files += 1
        try:
            with open(path, encoding="utf-8") as fh:
                mod = ModuleInfo(path, fh.read())
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{canon_path(path)}: {e}")
            continue
        kept, nsup = _apply_pragmas(mod, run_rules(mod, only))
        findings.extend(kept)
        suppressed += nsup
    return findings, suppressed, n_files, errors


def run(paths, baseline_path: str | None = None):
    """Full run with baseline applied.

    -> dict(new, baselined, stale, suppressed, files, errors)
    """
    findings, suppressed, n_files, errors = analyze_paths(paths)
    entries = []
    if baseline_path and os.path.exists(baseline_path):
        entries = baseline_mod.load(baseline_path)
    new, old, stale = baseline_mod.split(findings, entries)
    return {"new": new, "baselined": old, "stale": stale,
            "suppressed": suppressed, "files": n_files, "errors": errors}

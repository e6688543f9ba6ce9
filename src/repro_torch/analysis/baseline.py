"""Committed baseline of grandfathered findings.

The baseline (``scripts/planelint_torch_baseline.json``, the port's own;
never the JAX package's ``scripts/planelint_baseline.json``, whose
entries name ``src/repro/`` files) lists findings that
predate the analyzer and are deliberately kept — every entry must carry
a one-line ``reason``. Matching is by finding *key* (rule, file, scope,
detail), never by line number, so unrelated edits don't invalidate it.
A baseline entry that no longer matches any finding is *stale* and fails
the run: the baseline may only shrink toward empty, never rot.
"""
from __future__ import annotations

import json

from repro_torch.analysis.findings import canon_path

_FIELDS = ("rule", "file", "scope", "detail", "reason")


class BaselineError(ValueError):
    pass


def load(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("entries") if isinstance(data, dict) else data
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected {{'entries': [...]}}")
    for i, e in enumerate(entries):
        missing = [f for f in _FIELDS if not str(e.get(f, "")).strip()]
        if missing:
            raise BaselineError(
                f"{path}: entry {i} ({e.get('rule')}/{e.get('file')}) is "
                f"missing {', '.join(missing)} — every baseline entry "
                f"needs a one-line reason")
        e["file"] = canon_path(e["file"])
    return entries


def split(findings: list, entries: list[dict]):
    """-> (new_findings, baselined_findings, stale_entries)."""
    keys = {(e["rule"], e["file"], e["scope"], e["detail"]): e
            for e in entries}
    matched = set()
    new, old = [], []
    for f in findings:
        e = keys.get(f.key())
        if e is None:
            new.append(f)
        else:
            old.append(f)
            matched.add(f.key())
    stale = [e for k, e in keys.items() if k not in matched]
    return new, old, stale


def dump(findings: list, reason: str = "TODO: justify or fix") -> str:
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line)):
        if f.key() in seen:
            continue
        seen.add(f.key())
        entries.append({"rule": f.rule, "file": f.path, "scope": f.scope,
                        "detail": f.detail, "reason": reason})
    return json.dumps({"entries": entries}, indent=2) + "\n"

"""Finding records and report rendering for the plane-invariant analyzer.

A Finding is one rule violation at one source location. Its *key* —
``(rule, file, scope, detail)`` — deliberately excludes the line number,
so baseline entries survive unrelated edits that shift code up or down;
two violations of the same rule on the same detail inside one function
fold into one key on purpose (fixing the function fixes the key).

Departure from ``repro.analysis.findings``: ``canon_path`` anchors at
``src/repro_torch/``, and falls back to the absolute path when the path
as given does not hold the anchor, so a key is the same whether the
analyzer ran from the repo root, from ``src/`` or on an absolute path.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    rule: str           # "L1", "O1", ... (see rules.RULES)
    path: str           # canonical posix path (see canon_path)
    line: int           # 1-based source line
    scope: str          # dotted qualname of the enclosing def/class, or "<module>"
    detail: str         # rule-specific stable token (attr name, env var, callee)
    message: str        # human diagnostic

    def key(self) -> tuple:
        return (self.rule, self.path, self.scope, self.detail)

    def location(self) -> str:
        return f"{self.path}:{self.line}"


_ANCHOR = "src/repro_torch/"


def canon_path(path: str) -> str:
    """Posix-normalized path, anchored at ``src/repro_torch/`` when the
    path as given, or else its absolute form, holds it, so keys match no
    matter whether the analyzer was invoked on an absolute path,
    ``src/repro_torch``, ``repro_torch`` from ``src/``, or a
    subdirectory."""
    for p in (str(path), os.path.abspath(str(path))):
        p = p.replace("\\", "/")
        ix = p.rfind(_ANCHOR)
        if ix >= 0:
            return p[ix:]
    return str(path).replace("\\", "/").lstrip("./")


def format_text(findings: list, stale: list | None = None,
                suppressed: int = 0, baselined: int = 0,
                files: int = 0) -> str:
    lines = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        lines.append(f"{f.location()}: {f.rule} [{f.scope}] {f.message}")
    for entry in stale or []:
        lines.append(
            f"{entry.get('file')}: stale baseline entry "
            f"{entry.get('rule')} [{entry.get('scope')}] "
            f"{entry.get('detail')!r} — the finding no longer occurs; "
            f"remove it from the baseline")
    n_stale = len(stale or [])
    tail = (f"planelint: {len(findings)} finding(s), {n_stale} stale "
            f"baseline entr{'y' if n_stale == 1 else 'ies'} "
            f"({baselined} baselined, {suppressed} suppressed) "
            f"across {files} file(s)")
    lines.append(tail)
    return "\n".join(lines)


def format_json(findings: list, stale: list | None = None) -> str:
    return json.dumps({
        "findings": [{"rule": f.rule, "file": f.path, "line": f.line,
                      "scope": f.scope, "detail": f.detail,
                      "message": f.message} for f in findings],
        "stale": list(stale or []),
    }, indent=2, sort_keys=True)

"""Inline suppression pragmas.

``# planelint: allow(RULE) — reason`` suppresses findings of RULE on the
same line or the line directly below (so the pragma can sit above a long
statement). The reason is mandatory: a pragma without one does not
suppress anything and is itself reported (rule P1), so every suppression
in the tree carries its justification next to the code it excuses.

``# noqa`` (any flavor) additionally suppresses D1 on its line — the
repo already marks side-effect imports and re-exports that way.
"""
from __future__ import annotations

import re

from repro_torch.analysis.findings import Finding

_PRAGMA = re.compile(
    r"#\s*planelint:\s*allow\(\s*([A-Za-z0-9_*]+(?:\s*,\s*[A-Za-z0-9_*]+)*)"
    r"\s*\)\s*(.*)$")
_NOQA = re.compile(r"#\s*noqa\b", re.IGNORECASE)


class Suppressions:
    def __init__(self, path: str):
        self.path = path
        self.allow: dict[int, set] = {}      # line -> {"L1", ...} or {"*"}
        self.noqa: set[int] = set()
        self.malformed: list[Finding] = []

    def allows(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            rules = self.allow.get(ln)
            if rules and (rule in rules or "*" in rules):
                return True
        if rule == "D1" and line in self.noqa:
            return True
        return False


def scan(path: str, source: str) -> Suppressions:
    sup = Suppressions(path)
    for i, text in enumerate(source.splitlines(), start=1):
        if _NOQA.search(text):
            sup.noqa.add(i)
        m = _PRAGMA.search(text)
        if m is None:
            continue
        reason = m.group(2).strip().lstrip("—–-:").strip()
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not reason:
            sup.malformed.append(Finding(
                "P1", path, i, "<module>", ",".join(sorted(rules)),
                "planelint pragma without a reason — append "
                "'— why this is safe' or remove it"))
            continue
        sup.allow.setdefault(i, set()).update(rules)
    return sup

"""NetFilter: the paper's user-facing INC specification (§4, Fig. 3).

A NetFilter is a JSON configuration — deliberately *not* a program — with at
most one instance of each Reliable INC Primitive (RIP):

    {
      "AppName":   "DT-1",
      "Precision": 8,
      "get":    "AgtrGrad.tensor",     # Map.get target field (or "nop")
      "addTo":  "NewGrad.tensor",      # Map.addTo source field (or "nop")
      "clear":  "copy" | "shadow" | "lazy" | "nop",
      "modify": "nop" | {"op": "max", "para": 3},
      "CntFwd": {"to": "ALL"|"SRC"|"SERVER", "threshold": k, "key": field}
    }

This module parses/validates the file and classifies the application into
one of the four INC types of Table 1, which decides the channel kind the
runtime instantiates (SyncAgtr / AsyncAgtr / KeyValue / Agreement).
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.kernels.ref import STREAM_OPS

CLEAR_POLICIES = ("nop", "copy", "shadow", "lazy")
CNTFWD_TARGETS = ("ALL", "SRC", "SERVER")
APP_TYPES = ("SyncAgtr", "AsyncAgtr", "KeyValue", "Agreement")


@dataclass(frozen=True)
class CntFwdSpec:
    to: str = "SRC"
    threshold: int = 0
    key: str = "NULL"

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def __post_init__(self):
        if self.to not in CNTFWD_TARGETS:
            raise ValueError(f"CntFwd.to must be one of {CNTFWD_TARGETS}, "
                             f"got {self.to!r}")
        if self.threshold < 0:
            raise ValueError("CntFwd.threshold must be >= 0")


@dataclass(frozen=True)
class StreamModifySpec:
    op: str = "nop"
    para: int = 0

    def __post_init__(self):
        if self.op not in STREAM_OPS:
            raise ValueError(f"Stream.modify op must be one of {STREAM_OPS}, "
                             f"got {self.op!r}")


@dataclass(frozen=True)
class NetFilter:
    """Parsed + validated NetFilter. One instance of each RIP at most."""
    app_name: str
    precision: int = 0                 # fixed-point digits; scale = 10**p
    get: str = "nop"                   # Map.get target field
    add_to: str = "nop"                # Map.addTo source field
    clear: str = "nop"                 # Map.clear policy
    modify: StreamModifySpec = field(default_factory=StreamModifySpec)
    cnt_fwd: CntFwdSpec = field(default_factory=CntFwdSpec)

    def __post_init__(self):
        if not re.match(r"^[\w.-]+$", self.app_name):
            raise ValueError(f"bad AppName: {self.app_name!r}")
        if not (0 <= self.precision <= 9):
            raise ValueError(f"'Precision' must be in [0, 9] (10**p must "
                             f"fit the int32 fixed-point range headroom), "
                             f"got {self.precision} (app "
                             f"{self.app_name!r})")
        if self.clear not in CLEAR_POLICIES:
            raise ValueError(f"'clear' must be one of {CLEAR_POLICIES}, "
                             f"got {self.clear!r} (app {self.app_name!r})")

    @property
    def scale(self) -> float:
        return float(10 ** self.precision)

    def app_type(self) -> str:
        """Classify per Table 1 from which RIPs the filter enables."""
        if self.cnt_fwd.enabled:
            # counting votes to a threshold: Agreement; with a clear+array
            # stream it is the SyncAgtr commit gate
            if self.add_to != "nop" and self.clear != "nop":
                return "SyncAgtr"
            return "Agreement"
        if self.add_to != "nop" and self.get != "nop" and self.clear != "nop":
            return "SyncAgtr"
        if self.add_to != "nop":
            return "AsyncAgtr"
        return "KeyValue"

    @classmethod
    def from_dict(cls, d: dict) -> "NetFilter":
        """Parse + validate.  Unknown keys — top-level AND inside the
        nested ``modify``/``CntFwd`` blocks — are rejected (a typo'd RIP
        knob must not silently no-op), and every validation error names
        the offending key and the AppName so a multi-filter deployment
        (or the schema compiler, which reuses these messages) points at
        the broken app, not just a bare ValueError."""
        app = d.get("AppName", "<missing AppName>")

        def bad(msg: str) -> ValueError:
            return ValueError(f"NetFilter for app {app!r}: {msg}")

        known = {"AppName", "Precision", "get", "addTo", "clear", "modify",
                 "CntFwd"}
        unknown = set(d) - known
        if unknown:
            raise bad(f"unknown NetFilter field(s) {sorted(unknown)} "
                      f"(known: {sorted(known)})")
        modify = d.get("modify", "nop")
        if isinstance(modify, str):
            modify = {"op": modify}
        elif not isinstance(modify, dict):
            raise bad(f"'modify' must be an op name or "
                      f"{{'op':..,'para':..}}, got {modify!r}")
        unknown = set(modify) - {"op", "para"}
        if unknown:
            raise bad(f"unknown key(s) {sorted(unknown)} in 'modify' "
                      f"(known: ['op', 'para'])")
        cf = d.get("CntFwd", {})
        if not isinstance(cf, dict):
            raise bad(f"'CntFwd' must be a dict, got {cf!r}")
        unknown = set(cf) - {"to", "threshold", "key"}
        if unknown:
            raise bad(f"unknown key(s) {sorted(unknown)} in 'CntFwd' "
                      f"(known: ['key', 'threshold', 'to'])")
        try:
            return cls(app_name=d["AppName"],
                       precision=int(d.get("Precision", 0)),
                       get=d.get("get", "nop"),
                       add_to=d.get("addTo", "nop"),
                       clear=d.get("clear", "nop"),
                       modify=StreamModifySpec(
                           op=modify.get("op", "nop"),
                           para=int(modify.get("para", 0))),
                       cnt_fwd=CntFwdSpec(
                           to=cf.get("to", "SRC"),
                           threshold=int(cf.get("threshold", 0)),
                           key=cf.get("key", "NULL")))
        except ValueError as e:
            # constructor errors already name the field; add the app
            raise bad(str(e)) from None

    @classmethod
    def load(cls, path: str | Path) -> "NetFilter":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def to_dict(self) -> dict:
        return {
            "AppName": self.app_name, "Precision": self.precision,
            "get": self.get, "addTo": self.add_to, "clear": self.clear,
            "modify": ({"op": self.modify.op, "para": self.modify.para}
                       if self.modify.op != "nop" else "nop"),
            "CntFwd": {"to": self.cnt_fwd.to,
                       "threshold": self.cnt_fwd.threshold,
                       "key": self.cnt_fwd.key},
        }

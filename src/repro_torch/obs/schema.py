"""repro_torch.obs.schema — a dependency-free mini JSON-schema validator.

CI validates ``metrics_snapshot()`` (and the Chrome trace export)
against the checked-in ``scripts/obs_schema.json`` without assuming the
``jsonschema`` package exists in the image. Only the subset the obs
schemas use is implemented:

  type (object/array/string/number/integer/boolean/null), required,
  properties, additionalProperties (as a schema applied to non-declared
  keys), items, const, enum, minItems.

``validate`` raises ValueError with a JSON-pointer-ish path on the first
mismatch; anything else passes (permissive by design — the schema pins
the *stable* surface, not every key).
"""
from __future__ import annotations

import json
from pathlib import Path

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value, t: str) -> bool:
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value,
                                                                  bool)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    py = _TYPES.get(t)
    if py is None:
        raise ValueError(f"schema uses unsupported type {t!r}")
    return isinstance(value, py)


def validate(value, schema: dict, path: str = "$") -> None:
    """Raise ValueError unless ``value`` matches ``schema``."""
    if not isinstance(schema, dict):
        raise ValueError(f"{path}: schema node must be an object")
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, x) for x in types):
            raise ValueError(
                f"{path}: expected type {t}, got {type(value).__name__}")
    if "const" in schema and value != schema["const"]:
        raise ValueError(
            f"{path}: expected const {schema['const']!r}, got {value!r}")
    if "enum" in schema and value not in schema["enum"]:
        raise ValueError(
            f"{path}: {value!r} not in enum {schema['enum']}")
    if isinstance(value, dict):
        for k in schema.get("required", ()):
            if k not in value:
                raise ValueError(f"{path}: missing required key {k!r}")
        props = schema.get("properties", {})
        for k, sub in props.items():
            if k in value:
                validate(value[k], sub, f"{path}.{k}")
        extra = schema.get("additionalProperties")
        if isinstance(extra, dict):
            for k, v in value.items():
                if k not in props:
                    validate(v, extra, f"{path}.{k}")
    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            raise ValueError(
                f"{path}: needs >= {schema['minItems']} items, "
                f"has {len(value)}")
        items = schema.get("items")
        if isinstance(items, dict):
            for i, v in enumerate(value):
                validate(v, items, f"{path}[{i}]")


def load(path) -> dict:
    return json.loads(Path(path).read_text())


def repo_schema_path() -> Path:
    """The checked-in snapshot schema (scripts/obs_schema.json)."""
    return (Path(__file__).resolve().parents[3] / "scripts"
            / "obs_schema.json")

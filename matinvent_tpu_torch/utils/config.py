"""Reader for the flat ``config.yaml`` that MatterGen checkpoints carry.

``matinvent_tpu/models/suite/mattergen.py`` writes the model config with
``yaml.safe_dump`` as one ``key: value`` line per ``MatterGenConfig`` field.
The port reads that file without PyYAML: it accepts ``key: scalar`` lines
(null, booleans, integers, floats, plain or quoted strings) and ``key: []``,
and raises on anything nested (indented lines, sequences with items,
mappings), which it cannot represent.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any

_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(
    r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$"
)
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")


def parse_scalar(text: str) -> Any:
    """One YAML scalar as ``yaml.safe_load`` reads it, for the forms that
    ``yaml.safe_dump`` writes for a flat config."""
    s = text.strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in ("true", "True", "TRUE"):
        return True
    if s in ("false", "False", "FALSE"):
        return False
    if s == "[]":
        return []
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return s[1:-1]
    if s[0] in "[{&*!|>" or s == "-" or s.startswith("- ") or ": " in s or s.endswith(":"):
        raise ValueError(f"not a flat scalar: {text!r}")
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    low = s.lower()
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    if low == ".nan":
        return float("nan")
    return s


def read_flat_yaml(path: str | Path) -> dict[str, Any]:
    """``{key: value}`` of a flat YAML file; raises ``ValueError`` on any
    nested structure."""
    out: dict[str, Any] = {}
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.rstrip()
        if not line or line.lstrip().startswith("#"):
            continue
        if line[0] in " \t-":
            raise ValueError(f"{path}:{lineno}: nested YAML is not supported")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{path}:{lineno}: not a 'key: value' line: {raw!r}")
        if m.group(2) is None:
            raise ValueError(
                f"{path}:{lineno}: key {m.group(1)!r} opens a nested block"
            )
        try:
            out[m.group(1)] = parse_scalar(m.group(2))
        except ValueError as err:
            raise ValueError(f"{path}:{lineno}: {err}") from None
    return out

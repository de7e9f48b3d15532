"""Reader for the flat ``config.yaml`` that MatterGen checkpoints carry.

``matinvent_tpu/models/suite/mattergen.py`` writes the model config with
``yaml.safe_dump`` as one ``key: value`` line per ``MatterGenConfig`` field.
The port reads that file without PyYAML: it accepts ``key: scalar`` lines
(null, booleans, integers, floats, plain or quoted strings), ``key: []``,
and block sequences of scalars or of nested sequences under a key (the
forms ``yaml.safe_dump`` writes for ``condition_fields`` and
``condition_stats``). It raises on what it cannot represent: mappings below
the top level, block scalars, flow collections, anchors and tags.
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


def _parse_sequence(lines, i: int, indent: int, path) -> tuple[list, int]:
    """The block sequence whose ``- `` items start at column ``indent`` on
    ``lines[i]`` (``(lineno, column, text)`` with ``text`` from the column
    on); returns it and the index of the first line after it."""
    items = []
    while i < len(lines):
        lineno, col, text = lines[i]
        if col != indent or not (text == "-" or text.startswith("- ")):
            break
        rest = text[1:].lstrip(" ")
        if rest == "-" or rest.startswith("- "):
            # a compact nested sequence: "- - a" opens it on this line
            lines[i] = (lineno, col + len(text) - len(rest), rest)
            item, i = _parse_sequence(lines, i, lines[i][1], path)
        elif rest == "":
            nxt = lines[i + 1] if i + 1 < len(lines) else None
            if nxt is None or nxt[1] <= indent:
                raise ValueError(f"{path}:{lineno}: empty sequence item")
            item, i = _parse_sequence(lines, i + 1, nxt[1], path)
        else:
            if _KEY.match(rest):
                raise ValueError(f"{path}:{lineno}: mappings in sequences are not supported")
            try:
                item = parse_scalar(rest)
            except ValueError as err:
                raise ValueError(f"{path}:{lineno}: {err}") from None
            i += 1
        items.append(item)
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"{path}:{lines[i][0]}: unexpected indentation")
    return items, i


def read_flat_yaml(path: str | Path) -> dict[str, Any]:
    """``{key: value}`` of a flat YAML file whose values are scalars or
    block sequences (of scalars or nested sequences); raises
    ``ValueError`` on any other structure."""
    lines = []
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.rstrip()
        if not line or line.lstrip().startswith("#"):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"{path}:{lineno}: tab indentation")
        col = len(line) - len(line.lstrip(" "))
        lines.append((lineno, col, line[col:]))
    out: dict[str, Any] = {}
    i = 0
    while i < len(lines):
        lineno, col, text = lines[i]
        m = _KEY.match(text)
        if col != 0 or m is None:
            raise ValueError(f"{path}:{lineno}: not a top-level 'key: value' line: {text!r}")
        key, value = m.group(1), m.group(2)
        if value is None:
            nxt = lines[i + 1] if i + 1 < len(lines) else None
            if nxt is None or not (nxt[2] == "-" or nxt[2].startswith("- ")):
                raise ValueError(
                    f"{path}:{lineno}: key {key!r} opens a nested block that is not a sequence"
                )
            out[key], i = _parse_sequence(lines, i + 1, nxt[1], path)
            continue
        try:
            out[key] = parse_scalar(value)
        except ValueError as err:
            raise ValueError(f"{path}:{lineno}: {err}") from None
        i += 1
    return out
